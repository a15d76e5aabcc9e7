"""``parallel.sharded.minmax_fixed_sharded`` with an average half-width
other than 1 (no kernel: the plain block step under autograd, a halo of
``max(1, h)`` cells exchanged every step, each step checkpointed), float64
on (2,2,1) and (4,1,1) CPU shards:

* against the port's solo ``minmax_flow_fixed(avg_halfwidth=2)``: the
  values BITWISE, the gradients in phi0, dx and h1 at 1e-12 relative (the
  exchange's transpose adds the halo cotangents in another order than
  autograd's gather on the whole grid);
* against the JAX package's ``minmax_fixed_sharded(avg_halfwidth=2)`` on
  the virtual CPU devices (its jnp route): values and gradients at 1e-10
  relative.  The band stays off the global faces (ROADMAP H4), where the
  JAX package's block step has no face gate;
* on two gloo ranks (this file run as a script, ``python
  tests/test_torch_sharded_options.py <rank> <world> <port> <dir>``, two
  shards per rank): every rank's blocks, block gradients and
  scalar gradients BITWISE the one-process run, the scalars the same on
  both ranks.
"""

import os
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if __name__ == "__main__":
    sys.path.insert(0, ROOT)

from levelsetfortran_tpu_torch.parallel import distributed  # noqa: E402
from levelsetfortran_tpu_torch.parallel import sharded as sh  # noqa: E402
from levelsetfortran_tpu_torch.parallel.mesh import (  # noqa: E402
    gather_blocks, make_mesh, split_blocks)
from levelsetfortran_tpu_torch.solvers.minmax_flow import \
    minmax_flow_fixed  # noqa: E402

torch.set_num_threads(1)
N = (24, 24, 24)
DX = 2.4 / 23
H1 = 0.05 * DX * DX
STEPS = 5
MESHES = ((2, 2, 1), (4, 1, 1))
WORLD = 2
TIMEOUT_S = 240


def field(seed=0):
    """A sphere of radius 0.6 with noise; its band (4.1 dx) stays off the
    faces of [-1.2, 1.2]^3."""
    xs = np.linspace(-1.2, 1.2, N[0])
    gx, gy, gz = np.meshgrid(xs, xs, xs, indexing="ij")
    p = np.sqrt(gx ** 2 + gy ** 2 + gz ** 2) - 0.6
    return p + 0.02 * DX * np.random.default_rng(seed).standard_normal(N)


def upstream():
    return np.random.default_rng(9).standard_normal(N)


def sharded_case(mesh, halfwidth=2):
    """Blocks, block gradients and scalar gradients of one sharded solve
    (this rank's blocks only), as numpy."""
    blocks = [None if b is None else b.requires_grad_(True)
              for b in split_blocks(mesh, torch.tensor(field()))]
    scalars = [torch.tensor(v, dtype=torch.float64, requires_grad=True)
               for v in (DX, H1)]
    outs = sh.minmax_fixed_sharded(mesh, blocks, *scalars, STEPS,
                                   avg_halfwidth=halfwidth)
    w = split_blocks(mesh, torch.tensor(upstream()))
    sum(torch.sum(a * b) for a, b in zip(w, outs) if b is not None
        ).backward()
    out = {"scalars": np.array([float(t.grad) for t in scalars])}
    for i, (o, b) in enumerate(zip(outs, blocks)):
        if o is not None:
            out[f"out.{i}"] = o.detach().numpy()
            out[f"grad.{i}"] = b.grad.numpy()
    return out


def _rel(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_sharded_half_width_2_equals_the_solo_solve(mesh_shape):
    m = make_mesh(mesh_shape, ["cpu"])
    got = sharded_case(m)
    x = torch.tensor(field(), requires_grad=True)
    scalars = [torch.tensor(v, dtype=torch.float64, requires_grad=True)
               for v in (DX, H1)]
    ref = minmax_flow_fixed(x, *scalars, STEPS, avg_halfwidth=2)
    torch.sum(torch.tensor(upstream()) * ref).backward()
    blocks = [torch.tensor(got[f"out.{i}"]) for i in range(m.n_shards)]
    grads = [torch.tensor(got[f"grad.{i}"]) for i in range(m.n_shards)]
    assert torch.equal(gather_blocks(m, blocks), ref.detach())
    assert _rel(gather_blocks(m, grads).numpy(), x.grad.numpy()) <= 1e-12
    for a, s in zip(got["scalars"], scalars):
        assert abs(a - float(s.grad)) <= 1e-12 * abs(float(s.grad))
    assert not torch.equal(ref.detach(), minmax_flow_fixed(
        torch.tensor(field()), DX, H1, STEPS))


def test_sharded_half_width_2_matches_jax(eight_devices):
    import jax
    import jax.numpy as jnp

    from levelsetfortran_tpu.parallel.mesh import make_mesh as jax_mesh
    from levelsetfortran_tpu.parallel.sharded import \
        minmax_fixed_sharded as jax_fixed

    jm = jax_mesh((2, 2, 1), eight_devices[:4])
    w = jnp.asarray(upstream())

    def loss(p, dx, h1):
        return jnp.sum(w * jax_fixed(jm, p, dx, h1, STEPS, avg_halfwidth=2))

    args = (jnp.asarray(field()), jnp.float64(DX), jnp.float64(H1))
    want = np.asarray(jax_fixed(jm, *args, STEPS, avg_halfwidth=2))
    gw = jax.grad(loss, argnums=(0, 1, 2))(*args)
    m = make_mesh((2, 2, 1), ["cpu"])
    got = sharded_case(m)
    out = gather_blocks(m, [torch.tensor(got[f"out.{i}"]) for i in range(4)])
    grad = gather_blocks(m, [torch.tensor(got[f"grad.{i}"])
                             for i in range(4)])
    assert np.abs(want - field()).max() > 0
    assert _rel(out.numpy(), want) <= 1e-10
    assert _rel(grad.numpy(), np.asarray(gw[0])) <= 1e-10
    for a, b in zip(got["scalars"], gw[1:]):
        assert abs(a - float(b)) <= 1e-10 * abs(float(b))


def test_fused_route_is_taken_for_half_width_1_only(monkeypatch):
    """Half-width 1 keeps the kernel route (K3 / K6 block mode, their plain
    versions here); 2 never reaches it."""
    calls = []
    real = sh._MinmaxFixedSharded.apply
    monkeypatch.setattr(sh._MinmaxFixedSharded, "apply",
                        lambda *a: calls.append(1) or real(*a))
    m = make_mesh((2, 2, 1), ["cpu"])
    blocks = split_blocks(m, torch.tensor(field(), dtype=torch.float32))
    sh.minmax_fixed_sharded(m, blocks, DX, H1, 2, avg_halfwidth=2)
    assert calls == []
    sh.minmax_fixed_sharded(m, blocks, DX, H1, 2)
    assert calls == [1]


def worker(rank, world, port, out_dir):
    assert distributed.init_distributed(f"127.0.0.1:{port}", world, rank,
                                        device="cpu")
    for shape in MESHES:
        res = sharded_case(make_mesh(shape, ["cpu"]))
        tag = "".join(map(str, shape))
        np.savez(os.path.join(out_dir, f"{tag}-{rank}.npz"), **res)
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run the two workers once (the harness of
    ``test_torch_distributed_pipeline.py``); their output directory."""
    from test_torch_distributed_pipeline import run_workers
    out = tmp_path_factory.mktemp("ranks")
    run_workers(__file__, out, WORLD, TIMEOUT_S)
    return out


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_two_processes_equal_one(ranks, mesh_shape):
    tag = "".join(map(str, mesh_shape))
    saved = [dict(np.load(ranks / f"{tag}-{r}.npz")) for r in range(WORLD)]
    one = sharded_case(make_mesh(mesh_shape, ["cpu"]))
    seen = set()
    for rank_out in saved:
        for k, v in rank_out.items():
            np.testing.assert_array_equal(v, one[k], err_msg=k)
            seen.add(k)
    assert seen == set(one)
    np.testing.assert_array_equal(saved[0]["scalars"], saved[1]["scalars"])


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
