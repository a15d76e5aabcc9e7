"""K6's solve buffers (``minmax_cuda.VjpBuffers``) on the CPU: with them
the VJP entry points return the same field, None for the scalars, and add
the scalar cotangents into the buffers' running sums in launch order, as a
caller adds each step's to its total; the differentiable solvers that pass
them give the gradients of that step-by-step addition, bitwise.  The CUDA
kernel's own accumulation is checked on the card by ``chip_smoke.py``."""

import numpy as np
import pytest
import torch

from levelsetfortran_tpu_torch.ops import minmax_cuda as mc
from levelsetfortran_tpu_torch.ops import weno_cuda as wc
from levelsetfortran_tpu_torch.parallel import sharded as sh
from levelsetfortran_tpu_torch.parallel.halo import halo_exchange
from levelsetfortran_tpu_torch.parallel.mesh import make_mesh, split_blocks
from levelsetfortran_tpu_torch.solvers.minmax_flow import minmax_flow_fixed

DX = 0.05
H1 = 0.3 * DX * DX


def _field(shape, dtype, seed=3):
    ax = [(np.arange(n) - (n - 1) / 2.0) * DX for n in shape]
    g = np.meshgrid(*ax, indexing="ij")
    phi = np.sqrt(sum(x ** 2 for x in g)) - 0.3 * min(shape) * DX
    rng = np.random.default_rng(seed)
    return (torch.tensor(phi, dtype=dtype),
            torch.tensor(rng.standard_normal(shape), dtype=dtype))


def _cases(mode, dtype):
    """[(call(bufs), make())] of one mode."""
    if mode in ("dense", "banded"):
        phi, g = _field((21, 18, 26), dtype)
        act = None
        if mode == "banded":
            act = wc.tile_activity(phi, DX, 4.1, window="band4")
            act.view(-1)[::3] = 0

        def call(bufs):
            if act is None:
                return mc.minmax_step_vjp(phi, g, DX, H1, bufs=bufs)
            return mc.minmax_step_vjp_banded(phi, g, DX, H1, act, bufs=bufs)
        return [(call, lambda: mc.VjpBuffers(phi, DX, H1))]
    mesh = make_mesh((2, 2, 1), ["cpu"])
    phi, g = _field((22, 26, 18), dtype)
    w = sh.sharded_widths(mesh, wc.VJP_HALO["minmax"])
    geoms = sh.minmax_geoms(mesh, phi.shape, w)
    pads, gpads = ([p.contiguous() for p in halo_exchange(
        split_blocks(mesh, f), w, mesh)] for f in (phi, g))
    return [(lambda bufs, p=p, q=q, ge=ge: mc.minmax_step_block_vjp(
        p, q, DX, H1, ge, bufs=bufs),
        lambda p=p, ge=ge: mc.VjpBuffers(p, DX, H1, geom=ge))
        for p, q, ge in zip(pads, gpads, geoms)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mode", ["dense", "banded", "block"])
def test_buffers_add_the_scalar_cotangents_up(mode, dtype):
    """Two launches with one set of buffers: the field of a launch without
    them, bitwise, None for the scalars, and running sums (0 + s) + s."""
    for call, make in _cases(mode, dtype):
        ref = call(None)
        bufs = make()
        for _ in range(2):
            got = call(bufs)
            assert got[1] is None and got[2] is None
            assert torch.equal(got[0], ref[0])
        want = [(0.0 + float(v)) + float(v) for v in ref[1:]]
        assert [float(v) for v in bufs.sums] == want
        assert bufs.sums.dtype == torch.float64


def test_buffers_refuse_another_launch():
    """Buffers made for one grid, geometry or set of scalars raise for
    another."""
    phi, g = _field((21, 18, 26), torch.float32)
    bufs = mc.VjpBuffers(phi, DX, H1)
    with pytest.raises(ValueError, match="minmax_step_vjp"):
        mc.minmax_step_vjp(phi[:, :, :-1].contiguous(),
                           g[:, :, :-1].contiguous(), DX, H1, bufs=bufs)
    with pytest.raises(ValueError, match="minmax_step_vjp"):
        mc.minmax_step_vjp(phi, g, DX, 2 * H1, bufs=bufs)
    mesh = make_mesh((2, 2, 1), ["cpu"])
    w = sh.sharded_widths(mesh, wc.VJP_HALO["minmax"])
    geoms = sh.minmax_geoms(mesh, (22, 26, 18), w)
    pad = halo_exchange(split_blocks(mesh, _field((22, 26, 18),
                                                  torch.float32)[0]),
                        w, mesh)[0].contiguous()
    bufs = mc.VjpBuffers(pad, DX, H1, geom=geoms[0])
    with pytest.raises(ValueError, match="minmax_step_block_vjp"):
        mc.minmax_step_block_vjp(pad, pad, DX, H1, geoms[1], bufs=bufs)


def _step_sums(phi0, g, steps):
    """The scalar cotangents of ``steps`` dense steps, each step's VJP sums
    added to the totals in reverse step order (the solvers' order before
    they passed buffers)."""
    traj = [phi0]
    for _ in range(steps - 1):
        traj.append(mc.minmax_step_plain(traj[-1], DX, H1))
    gp = g
    cdx = ch = torch.zeros((), dtype=torch.float64)
    for p in reversed(traj):
        gp, a, b = mc.minmax_step_vjp_plain(p, gp, DX, H1)
        cdx, ch = cdx + a, ch + b
    return gp, cdx, ch


@pytest.mark.parametrize("solver", ["dense", "banded", "sharded"])
def test_solvers_sum_the_steps_in_order(solver):
    """The fixed-step min/max solvers' gradients: the field cotangent and
    the dx and h1 cotangents of the step-by-step addition, bitwise."""
    steps = 4
    phi0, g = _field((24, 20, 18), torch.float64)
    want = _step_sums(phi0, g, steps)
    dx = torch.tensor(DX, dtype=torch.float64, requires_grad=True)
    h1 = torch.tensor(H1, dtype=torch.float64, requires_grad=True)
    p = phi0.clone().requires_grad_(True)
    if solver == "dense":
        out = minmax_flow_fixed(p, dx, h1, steps)
    elif solver == "banded":
        out = mc.minmax_scan(p, dx, h1, steps, banded=True, refresh_every=3)
    else:
        mesh = make_mesh((2, 2, 1), ["cpu"])
        blocks = [b.contiguous() for b in split_blocks(mesh, p)]
        outs = sh.minmax_fixed_sharded(mesh, blocks, dx, h1, steps)
        gb = split_blocks(mesh, g)
        loss = sum((o * q).sum() for o, q in zip(outs, gb))
        gp, gdx, gh1 = torch.autograd.grad(loss, (p, dx, h1))
        assert torch.equal(gp, want[0])
        # the shards' sums are added in shard order, not cell order
        assert abs(float(gdx) - float(want[1])) <= 1e-12 * abs(float(want[1]))
        assert abs(float(gh1) - float(want[2])) <= 1e-12 * abs(float(want[2]))
        return
    gp, gdx, gh1 = torch.autograd.grad((out * g).sum(), (p, dx, h1))
    assert torch.equal(gp, want[0])
    assert float(gdx) == float(want[1]) and float(gh1) == float(want[2])
