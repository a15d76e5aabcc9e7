"""Checkpoint/resume of the port (``utils/checkpoint.py``,
``solvers/checkpointed.py``) against the JAX package's.

The port's resumable solvers run the plain versions of K1/K3 on the CPU,
the JAX package's its jnp route.  Tolerances: float64 1e-9 (the same
expressions, reassociated: measured 4.4e-16); float32 the kernels' H5
tolerances, 1e-6 for the reinit and 1e-7 for the min/max flow (measured
2.4e-7 and 3.0e-8).  A resumed solve is held bitwise to an uninterrupted
one: every chunk freezes the sign source at phi0.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from levelsetfortran_tpu.solvers import checkpointed as jck
from levelsetfortran_tpu.utils.checkpoint import \
    FieldCheckpointer as JaxCheckpointer
from levelsetfortran_tpu_torch.parallel.mesh import (gather_blocks,
                                                     make_mesh, split_blocks)
from levelsetfortran_tpu_torch.parallel.sharded import ShardedLevelSet
from levelsetfortran_tpu_torch.solvers import checkpointed as ck
from levelsetfortran_tpu_torch.solvers.minmax_flow import minmax_flow
from levelsetfortran_tpu_torch.solvers.reinit import reinit
from levelsetfortran_tpu_torch.utils.checkpoint import (FieldCheckpointer,
                                                        save_stage_field)

torch.set_num_threads(1)
DX = 0.1


def _sphere(n=24, dtype=np.float64, scale=2.0):
    """``tests/test_checkpoint.py:_sphere``: 2(|x| - 0.6) on [-1.2, 1.2]^3."""
    xs = np.linspace(-1.2, 1.2, n).astype(np.float32)
    gx, gy, gz = np.meshgrid(xs, xs, xs, indexing="ij")
    return (scale * (np.sqrt(gx ** 2 + gy ** 2 + gz ** 2) - 0.6)).astype(
        dtype)


def _same(a, b):
    assert torch.equal(a, b), float((a - b).abs().max())


# ------------------------------ checkpointer ------------------------------

def test_round_trips_a_tensor_and_a_block_list(tmp_path):
    phi = torch.tensor(_sphere(12, np.float32))
    blocks = split_blocks(make_mesh((2, 2, 1), ["cpu"]), phi)
    with FieldCheckpointer(str(tmp_path / "a")) as c:
        assert c.latest_step() is None and c.restore() is None
        assert c.save(3, phi, extra={"rms": 0.5}, wait=True)
        state = c.restore()
    assert state["step"] == 3 and state["extra"] == {"rms": 0.5}
    _same(state["phi"], phi)
    with FieldCheckpointer(str(tmp_path / "b")) as c:
        c.save(7, blocks, extra={"iterations": 7})
        back = c.restore()
        assert sorted(os.listdir(tmp_path / "b" / "7")) == [
            "meta.json", "phi.0.pt", "phi.1.pt", "phi.2.pt", "phi.3.pt"]
    assert back["extra"]["iterations"] == 7
    for a, b in zip(back["phi"], blocks):
        _same(a, b)


def test_prunes_to_max_to_keep_and_skips_old_steps(tmp_path):
    c = FieldCheckpointer(str(tmp_path), max_to_keep=2)
    phi = torch.zeros(4, 4, 4)
    for s in (1, 2, 3, 4):
        assert c.save(s, phi + s)
    assert c.all_steps() == [3, 4]
    assert not c.save(4, phi) and not c.save(2, phi)
    _same(c.restore(3)["phi"], phi + 3)
    every3 = FieldCheckpointer(str(tmp_path / "i"), save_interval_steps=3)
    assert [every3.save(s, phi) for s in (1, 2, 3, 4, 6)] == [
        True, False, True, False, True]


def test_ignores_a_leftover_temporary_directory(tmp_path):
    c = FieldCheckpointer(str(tmp_path))
    c.save(5, torch.ones(3, 3, 3))
    # a save killed half way: a temporary directory without its rename
    os.makedirs(tmp_path / ".tmp.9.12345")
    torch.save(torch.zeros(3, 3, 3), tmp_path / ".tmp.9.12345" / "phi.pt")
    assert c.latest_step() == 5
    _same(c.restore()["phi"], torch.ones(3, 3, 3))


def test_like_sets_device_and_dtype_and_a_mismatch_raises(tmp_path):
    c = FieldCheckpointer(str(tmp_path))
    phi = torch.tensor(_sphere(8, np.float32))
    c.save(1, phi)
    got = c.restore(like=torch.zeros(8, 8, 8, dtype=torch.float64))
    assert got["phi"].dtype == torch.float64
    assert got["phi"].device == torch.device("cpu")
    _same(got["phi"], phi.double())
    with pytest.raises(ValueError):
        c.restore(like=torch.zeros(8, 8, 9))
    with pytest.raises(ValueError):
        c.restore(like=[torch.zeros(8, 8, 8)])
    c.save(2, [phi[:4], phi[4:]])
    with pytest.raises(ValueError):
        c.restore(like=[phi[:4]])
    with pytest.raises(ValueError):
        c.restore(like=phi)


def test_meta_is_json_and_a_stage_field_is_written(tmp_path):
    from levelsetfortran_tpu_torch.grid.grid import Grid3D
    from levelsetfortran_tpu_torch.io.vti import read_vti
    c = FieldCheckpointer(str(tmp_path / "c"))
    c.save(2, torch.zeros(2, 2, 2), extra={"stage": "minmax", "rms": 1e-3})
    with open(tmp_path / "c" / "2" / "meta.json") as f:
        assert json.load(f)["extra"] == {"stage": "minmax", "rms": 1e-3}
    phi = torch.tensor(_sphere(6, np.float32))
    save_stage_field(str(tmp_path / "f.npy"), phi)
    np.testing.assert_array_equal(np.load(tmp_path / "f.npy"), phi.numpy())
    grid = Grid3D(shape=(6, 6, 6), origin=(0.0, 0.0, 0.0), dx=0.5)
    save_stage_field(str(tmp_path / "f.vti"), phi, grid)
    np.testing.assert_array_equal(read_vti(str(tmp_path / "f.vti"))[0],
                                  phi.double().numpy())


# ---------------------------- resumable solvers ----------------------------

def test_resumed_reinit_is_bitwise_the_uninterrupted_one(tmp_path):
    """``tests/test_checkpoint.py:31-51``: 20 iterations in chunks of 10,
    then resumed to 60 from a fresh checkpointer on the same directory."""
    phi0 = torch.tensor(_sphere(dtype=np.float32))
    h, tol = 0.005, 1e-6
    full = ck.reinit_resumable(phi0, DX, h, 60, tol, chunk=60)
    assert full.resumed_from is None
    with FieldCheckpointer(str(tmp_path)) as c:
        part = ck.reinit_resumable(phi0, DX, h, 20, tol, ckpt=c, chunk=10)
    assert part.iterations == 20 and not part.converged
    with FieldCheckpointer(str(tmp_path)) as c:
        resumed = ck.reinit_resumable(phi0, DX, h, 60, tol, ckpt=c,
                                      chunk=10)
        assert c.all_steps() == [40, 50, 60]
    assert resumed.resumed_from == 20 and resumed.iterations == 60
    _same(resumed.phi, full.phi)
    _same(full.phi, reinit(phi0, DX, h, 60, tol).phi)


def _summary(r):
    return (int(r.iterations), bool(r.converged), bool(r.diverged),
            r.resumed_from)


@pytest.mark.parametrize("dtype,stage", [
    (np.float64, "reinit"), (np.float64, "minmax"),
    (np.float32, "reinit"), (np.float32, "minmax")])
def test_resumable_solvers_match_jax(dtype, stage):
    phi0 = _sphere(20, dtype)
    if stage == "reinit":
        args, chunk = (DX, 0.005, 60, 1e-4), 8
        ours = ck.reinit_resumable(torch.tensor(phi0), *args, chunk=chunk)
        ref = jck.reinit_resumable(jnp.asarray(phi0), *args, chunk=chunk)
    else:
        args, chunk = (DX, 0.001, 20, 0.0), 7
        ours = ck.minmax_resumable(torch.tensor(phi0), *args, chunk=chunk)
        ref = jck.minmax_resumable(jnp.asarray(phi0), *args, chunk=chunk)
    assert _summary(ours) == _summary(ref)
    tol = 1e-9 if dtype == np.float64 else {"reinit": 1e-6,
                                             "minmax": 1e-7}[stage]
    np.testing.assert_allclose(ours.phi.numpy(), np.asarray(ref.phi),
                               rtol=0, atol=tol)


def test_divergence_detection_stops_where_jax_stops():
    """``tests/test_checkpoint.py:54-60``: h = 5 makes the Euler update
    unstable; the RMS rises over two chunks."""
    phi0 = _sphere(16)
    ours = ck.reinit_resumable(torch.tensor(phi0), DX, 5.0, 500, 0.0,
                               chunk=10)
    ref = jck.reinit_resumable(jnp.asarray(phi0), DX, 5.0, 500, 0.0,
                               chunk=10)
    assert ours.diverged and ours.iterations < 500
    assert _summary(ours) == _summary(ref)


def test_a_converged_stage_resumed_takes_one_more_step(tmp_path):
    """After a restore, iterations < iters still holds, so one more chunk
    runs and its first step stops it again: the JAX package's rule."""
    phi0 = _sphere(16)
    args = (DX, 0.005, 400, 2e-3)
    results = []
    for pkg, ckpt_cls, solve, x in (
            ("port", FieldCheckpointer, ck.reinit_resumable,
             torch.tensor(phi0)),
            ("jax", JaxCheckpointer, jck.reinit_resumable,
             jnp.asarray(phi0))):
        d = str(tmp_path / pkg)
        with ckpt_cls(d) as c:
            first = solve(x, *args, ckpt=c, chunk=200)
        with ckpt_cls(d) as c:
            again = solve(x, *args, ckpt=c, chunk=200)
        assert first.converged and first.iterations < 200
        assert again.converged and again.resumed_from == first.iterations
        assert again.iterations == first.iterations + 1
        results.append((_summary(first), _summary(again)))
    assert results[0] == results[1]


def test_a_jax_state_resumes_in_the_port(tmp_path):
    """The numpy phi of a JAX solve stopped at step 20, written as a port
    checkpoint: the port resumes from it to the JAX uninterrupted result."""
    phi0 = _sphere(20)
    args = (DX, 0.005, 50, 0.0)
    stopped = jck.reinit_resumable(jnp.asarray(phi0), *args[:2], 20, 0.0,
                                   chunk=20)
    full = jck.reinit_resumable(jnp.asarray(phi0), *args, chunk=10)
    with FieldCheckpointer(str(tmp_path)) as c:
        c.save(20, torch.tensor(np.asarray(stopped.phi)),
               extra={"iterations": 20, "stage": "reinit"})
        ours = ck.reinit_resumable(torch.tensor(phi0), *args, ckpt=c,
                                   chunk=10)
    assert ours.resumed_from == 20 and ours.iterations == 50
    np.testing.assert_allclose(ours.phi.numpy(), np.asarray(full.phi),
                               rtol=0, atol=1e-9)


@pytest.mark.parametrize("stage", ["reinit", "minmax"])
def test_sharded_resumed_solve_is_bitwise_the_solo_one(tmp_path, stage):
    """(2,2,1) blocks on the CPU: interrupted after two chunks, resumed
    from a fresh checkpointer, bitwise the uninterrupted sharded solve and
    the solo dense solve (tol 0: fixed counts)."""
    phi = torch.tensor(_sphere(16, np.float32))
    mesh = make_mesh((2, 2, 1), ["cpu"])
    solver = ShardedLevelSet(mesh, phi.shape, DX)
    blocks = solver.device_put(phi)
    if stage == "reinit":
        solve, h = ck.reinit_resumable_sharded, 0.005
        solo = reinit(phi, DX, h, 12, 0.0).phi
    else:
        solve, h = ck.minmax_resumable_sharded, 0.001
        solo = minmax_flow(phi, DX, h, 12, 0.0).phi
    full = solve(solver, blocks, h, 12, 0.0, chunk=12)
    with FieldCheckpointer(str(tmp_path)) as c:
        part = solve(solver, blocks, h, 8, 0.0, ckpt=c, chunk=4)
        assert sorted(os.listdir(tmp_path / "8")) == [
            "meta.json", "phi.0.pt", "phi.1.pt", "phi.2.pt", "phi.3.pt"]
    assert part.iterations == 8 and not part.converged
    with FieldCheckpointer(str(tmp_path)) as c:
        resumed = solve(solver, blocks, h, 12, 0.0, ckpt=c, chunk=4)
    assert resumed.resumed_from == 8 and resumed.iterations == 12
    assert isinstance(resumed.phi, list) and len(resumed.phi) == 4
    _same(gather_blocks(mesh, resumed.phi), gather_blocks(mesh, full.phi))
    _same(gather_blocks(mesh, full.phi), solo)


def test_a_sharded_chunk_overshoots_by_less_than_k():
    """Steps go in exchanges of k = 2: each chunk of 5 runs 6 steps, and
    the total adds what was run (as in the JAX package)."""
    phi = torch.tensor(_sphere(16, np.float32))
    solver = ShardedLevelSet(make_mesh((2, 1, 1), ["cpu"]), phi.shape, DX,
                             steps_per_exchange=2)
    r = ck.reinit_resumable_sharded(solver, solver.device_put(phi), 0.005,
                                    11, 0.0, chunk=5)
    assert r.iterations == 12
