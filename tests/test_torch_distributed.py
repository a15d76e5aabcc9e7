"""Several processes: ``init_distributed``, and ``ShardedLevelSet`` on a mesh
split across two processes (gloo on the CPU), against the one-process port
and the JAX package.

A module-scoped fixture starts two worker processes once (this file run as
a script, ``python tests/test_torch_distributed.py <rank> <world> <port>
<dir>``).  They join a gloo group at 127.0.0.1, build the meshes (4, 1, 1)
and (2, 2, 1) with ``devices=["cpu"]`` (two shards per rank, so the
exchange mixes same-process copies and cross-process slabs), run every
case for 4 steps at tol 0 and save their own blocks, the count and the RMS.

Gates: each rank's blocks and the RMS BITWISE the one-process
``ShardedLevelSet`` on the same mesh (the same block steps, and the global
sum added in shard order either way); the same RMS on both ranks; against
the JAX package's ``reinit_fixed(..., use_pallas=False)`` and
``minmax_flow_fixed(..., use_pallas=False)`` within 2e-6 (the JAX
two-process worker's gate, ``tests/_mp_worker.py``), the banded reinit in
its band.  The overlapped cases run on grids whose blocks hold interior
bricks (24 cells along the sharded axes), which (32, 16, 16) does not.
"""

import json
import os
import socket
import subprocess
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
from levelsetfortran_tpu_torch.parallel.mesh import make_mesh  # noqa: E402

WORLD = 2
MESHES = ((4, 1, 1), (2, 2, 1))
GSHAPE = (32, 16, 16)
OVERLAP_GSHAPE = {(4, 1, 1): (96, 16, 16), (2, 2, 1): (48, 48, 16)}
STEPS = 4
#: case -> (solver, ShardedLevelSet keywords)
CASES = {
    "reinit_k1": ("reinit", {}),
    "reinit_k2": ("reinit", {"steps_per_exchange": 2}),
    "reinit_banded": ("reinit", {"narrow_band": True}),
    "reinit_overlap": ("reinit", {"overlap": True}),
    "minmax_dense": ("minmax", {}),
    "minmax_banded": ("minmax", {"narrow_band": True}),
}
#: The workers' timeout (their solves take ~1 s; starting takes ~5 s).
TIMEOUT_S = 240


def field(gshape, seed=0):
    """The JAX two-process worker's distorted sphere, ``2 (|x| - 0.6)`` on
    ``linspace(-1, 1)`` points, with seeded noise of 1e-3, float32."""
    xs = [np.linspace(-1.0, 1.0, g) for g in gshape]
    gx, gy, gz = np.meshgrid(*xs, indexing="ij")
    noise = np.random.default_rng(seed).standard_normal(gshape)
    return (2.0 * (np.sqrt(gx ** 2 + gy ** 2 + gz ** 2) - 0.6)
            + 1e-3 * noise).astype(np.float32)


def case_inputs(case, mesh_shape):
    """(global shape, field, dx, step) of one case."""
    gshape = OVERLAP_GSHAPE[mesh_shape] if case == "reinit_overlap" \
        else GSHAPE
    dx = 2.0 / (gshape[0] - 1)
    step = 0.1 * dx if CASES[case][0] == "reinit" else 0.05 * dx * dx
    return gshape, field(gshape), dx, step


def solve(mesh, case, mesh_shape, metrics_every=0):
    """The case's solve on ``mesh``: (blocks, iterations, rms, solver)."""
    kind, kw = CASES[case]
    gshape, phi, dx, step = case_inputs(case, mesh_shape)
    s = sh.ShardedLevelSet(mesh, gshape, dx, metrics_every=metrics_every,
                           **kw)
    if case == "reinit_overlap" and not s.use_overlap:
        raise AssertionError("the overlapped step did not engage")
    blocks = s.device_put(torch.from_numpy(phi))
    if kind == "reinit":
        out, n, rms = s.reinit(blocks, step, STEPS, 0.0)
    else:
        out, n, rms = s.minmax_flow(blocks, step, STEPS, 0.0)
    return out, n, rms, s


def worker(rank, world, port, out_dir):
    """One rank: every case on both meshes, its blocks saved."""
    from levelsetfortran_tpu_torch.utils import logging as lg
    from levelsetfortran_tpu_torch.utils.logging import log_event
    lg.configure()
    torch.set_num_threads(1)
    assert distributed.init_distributed(f"127.0.0.1:{port}", world, rank,
                                        device="cpu")
    assert distributed.init_distributed() is True        # idempotent
    assert distributed.is_primary() == (rank == 0)
    log_event("worker", rank=rank)
    for mesh_shape in MESHES:
        mesh = make_mesh(mesh_shape, ["cpu"])
        local = [i for i in range(mesh.n_shards) if mesh.is_local(i)]
        assert mesh.spans_processes and len(local) == 2
        for case in CASES:
            out, n, rms, s = solve(mesh, case, mesh_shape,
                                   metrics_every=1 if case == "reinit_k1"
                                   else 0)
            assert [i for i, b in enumerate(out) if b is not None] == local
            whole = s.gather(out)
            np.savez(os.path.join(out_dir, f"{case}-{mesh_shape[0]}"
                                           f"{mesh_shape[1]}-{rank}.npz"),
                     n=n, rms=rms, local=np.asarray(local),
                     gathered=(whole.numpy() if whole is not None
                               else np.zeros(0, np.float32)),
                     **{f"b{i}": out[i].numpy() for i in local})
    torch.distributed.destroy_process_group()
    print(json.dumps({"done": rank}), flush=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Start the two workers once; their output directory and logs."""
    out = tmp_path_factory.mktemp("ranks")
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    logs = [open(out / f"rank{r}.log", "w+") for r in range(WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(WORLD), str(port), str(out)],
        cwd=ROOT, env=env, stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(WORLD)]
    try:
        for p in procs:
            p.wait(timeout=TIMEOUT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    texts = []
    for f in logs:
        f.seek(0)
        texts.append(f.read())
        f.close()
    for r, (p, text) in enumerate(zip(procs, texts)):
        assert p.returncode == 0, f"rank {r} rc={p.returncode}:\n{text[-3000:]}"
    return out, texts


def _records(text):
    recs = []
    for line in text.splitlines():
        if line.startswith("{"):
            recs.append(json.loads(line))
    return recs


def test_no_group_is_one_process():
    assert distributed.init_distributed() is False
    assert distributed.is_primary() and not distributed.active()
    with pytest.raises(ValueError, match="coordinator_address"):
        distributed.init_distributed(num_processes=2)
    with pytest.raises(ValueError, match="num_processes and process_id"):
        distributed.init_distributed("127.0.0.1:1")


def test_only_rank_0_logs(ranks):
    """``log_event`` and the metrics stream emit on the primary only."""
    _, texts = ranks
    first, second = (_records(t) for t in texts)
    assert [r["rank"] for r in first if r.get("stage") == "worker"] == [0]
    iters = [r["iteration"] for r in first if r.get("stage") == "iteration"]
    assert iters == list(range(1, STEPS + 1)) * len(MESHES)
    assert [r for r in second if "stage" in r] == []
    assert {"done": 1} in second


def _jax_reference(case, mesh_shape):
    import jax.numpy as jnp
    from levelsetfortran_tpu.solvers.minmax_flow import minmax_flow_fixed
    from levelsetfortran_tpu.solvers.reinit import reinit_fixed
    gshape, phi, dx, step = case_inputs(case, mesh_shape)
    if CASES[case][0] == "reinit":
        out = reinit_fixed(jnp.asarray(phi), dx, step, STEPS, remat=False,
                           use_pallas=False)
    else:
        out = minmax_flow_fixed(jnp.asarray(phi), dx, step, STEPS,
                                remat=False, use_pallas=False)
    return np.asarray(out), phi, dx


@pytest.mark.parametrize("mesh_shape", MESHES, ids=lambda m: "x".join(
    map(str, m)))
@pytest.mark.parametrize("case", list(CASES))
def test_two_processes_equal_one(ranks, case, mesh_shape):
    out_dir, _ = ranks
    tag = f"{case}-{mesh_shape[0]}{mesh_shape[1]}"
    saved = [dict(np.load(out_dir / f"{tag}-{r}.npz")) for r in range(WORLD)]
    one, n, rms, s = solve(make_mesh(mesh_shape, ["cpu"]), case, mesh_shape)
    # the ranks' blocks, bitwise the one-process solve's
    seen = []
    for rank_out in saved:
        assert int(rank_out["n"]) == n == STEPS
        assert float(rank_out["rms"]) == rms          # bitwise, every rank
        for i in rank_out["local"]:
            np.testing.assert_array_equal(rank_out[f"b{i}"],
                                          one[int(i)].numpy())
            seen.append(int(i))
    assert sorted(seen) == list(range(len(one)))
    whole = s.gather(one).numpy()
    np.testing.assert_array_equal(saved[0]["gathered"], whole)
    assert saved[1]["gathered"].size == 0       # gathered on rank 0 only
    # against the JAX package's single-device solver
    ref, phi, dx = _jax_reference(case, mesh_shape)
    where = np.ones(phi.shape, bool)
    if case == "reinit_banded":
        where = np.abs(phi) < 8.1 * dx
    np.testing.assert_allclose(whole[where], ref[where], rtol=0, atol=2e-6)


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
