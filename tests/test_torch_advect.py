"""K8, the node advection (``ops/advect_cuda.py``), on the CPU: the port's
``advect_nodes`` against the JAX package's on a small sphere, the route
(float32 takes the wrapper, bfloat16 and float64 the plain loop), and off
the CPU the wrapper launches K8 or raises.  K8 itself runs on the card only
(``chip_smoke.py`` phase 17 holds it bitwise against the plain loop
there).  Also the spelled-out three-term sum that the plain versions of K7
and K8 use instead of ``torch.sum``, which it equals on the CPU.

Tolerances: float64 atol 1e-12; float32 atol 2e-6 (the two packages' CPU
kernels round the square root and the division by dx their own ways, and
300 iterations carry that into the last bits of the positions); the sum
bitwise.
"""

import contextlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from levelsetfortran_tpu.grid.grid import Grid3D as JGrid
from levelsetfortran_tpu.solvers import advect as jadvect
from levelsetfortran_tpu_torch import cuda_build
from levelsetfortran_tpu_torch.grid.grid import Grid3D
from levelsetfortran_tpu_torch.ops import advect_cuda
from levelsetfortran_tpu_torch.ops.interp import dot3
from levelsetfortran_tpu_torch.solvers import advect as tadvect

torch.set_num_threads(1)
SHAPE, DX, ORIGIN = (26, 24, 22), 0.08, (-1.01, -0.93, -0.87)
TOL = {torch.float64: 1e-12, torch.float32: 2e-6}


def _sphere(radius=0.55):
    axes = [o + DX * np.arange(n) for o, n in zip(ORIGIN, SHAPE)]
    x, y, z = np.meshgrid(*axes, indexing="ij")
    return np.sqrt(x ** 2 + y ** 2 + (z - 0.03) ** 2) - radius


def _nodes(n=120, seed=11):
    pts = np.random.default_rng(seed).uniform(-0.8, 0.8, size=(n, 3))
    pts[0] = (3.0, -3.0, 0.1)             # off the grid: clamped samples
    return pts


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["float64", "float32"])
def test_advect_nodes_matches_jax(dtype):
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    phi, pts = _sphere(), _nodes()
    a = jadvect.advect_nodes(jnp.asarray(phi, jdt), JGrid(SHAPE, ORIGIN, DX),
                             jnp.asarray(pts, jdt), DX, iters=300)
    b = tadvect.advect_nodes(torch.tensor(phi, dtype=dtype),
                             Grid3D(SHAPE, ORIGIN, DX),
                             torch.tensor(pts, dtype=dtype), DX, iters=300)
    assert b.positions.dtype == dtype and b.phi_surf.dtype == dtype
    np.testing.assert_allclose(b.positions.numpy(), np.asarray(a.positions),
                               rtol=0, atol=TOL[dtype])
    np.testing.assert_allclose(b.phi_surf.numpy(), np.asarray(a.phi_surf),
                               rtol=0, atol=TOL[dtype])
    # only nodes outside move (phi > eps): they reached the sphere (the
    # off-grid node only its clamp)
    assert b.phi_surf.numpy()[1:].max() < 1e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
def test_advect_routes_by_dtype(dtype, monkeypatch):
    """float32 goes through K8's wrapper (the plain loop on the CPU);
    bfloat16 and float64 run the plain loop directly."""
    calls = {"advect": 0, "advect_plain": 0}
    for name in calls:
        real = getattr(advect_cuda, name)

        def wrap(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(advect_cuda, name, wrap)
    res = tadvect.advect_nodes(torch.tensor(_sphere()).to(dtype),
                               Grid3D(SHAPE, ORIGIN, DX),
                               torch.tensor(_nodes()).to(dtype), DX, iters=5)
    assert res.positions.dtype == dtype
    f32 = dtype == torch.float32
    assert calls == {"advect": int(f32), "advect_plain": 1}


@contextlib.contextmanager
def _no_card(monkeypatch):
    """Meta tensors stand in for the card's: the launch records its entry
    and arguments and raises as a launch with no library would."""
    launched = []

    def launch(name, *args):
        launched.append((name, args))
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(cuda_build, "launch", launch)
    monkeypatch.setattr(advect_cuda, "on_device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(advect_cuda, "advect_plain",
                        lambda *a, **k: pytest.fail("fell back"))
    yield launched


def test_advect_launches_or_raises_off_the_cpu(monkeypatch):
    grid = Grid3D(SHAPE, ORIGIN, DX)

    def args(dtype, shape=SHAPE):
        return (torch.empty(shape, dtype=dtype, device="meta"),
                torch.empty(shape + (3,), dtype=dtype, device="meta"), grid,
                torch.empty((40, 3), dtype=dtype, device="meta"))

    with _no_card(monkeypatch) as launched:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            advect_cuda.advect(*args(torch.float32), 1000, 1e-13)
        ((name, a),) = launched
        assert name == "lsf_advect_nodes_f32"
        assert len(a) == len(cuda_build.SIGNATURES[name])
        assert a[5:9] == (40, *SHAPE) and a[13] == 1000
        # world_to_index on the card: times float32(1 / dx), the reciprocal
        # taken in double (not float32(1) / float32(dx): they part at 0.015)
        assert a[12] == float(np.float32(1.0 / DX))
        assert np.float32(1.0 / 0.015) != np.float32(1) / np.float32(0.015)
        with pytest.raises(ValueError, match="float32"):
            advect_cuda.advect(*args(torch.float64), 1000, 1e-13)
        with pytest.raises(ValueError, match="grid"):
            advect_cuda.advect(*args(torch.float32, (26, 24, 21)), 10, 0.0)
        assert len(launched) == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
def test_dot3_is_torch_sum_on_the_cpu(dtype):
    g = torch.Generator().manual_seed(3)
    u = torch.randn((4096, 3), generator=g).to(dtype)
    v = torch.randn((4096, 3), generator=g).to(dtype)
    assert torch.equal(dot3(u, v), torch.sum(u * v, dim=-1))
