"""Several processes, the rest: ``run_mesh`` with ``mesh_shape`` under a
process group, the sharded checkpointed solves, the differentiable sharded
path, the periodic halo exchange and its transpose, and the sharded
advection, on meshes split across two processes (gloo on the CPU), against
the one-process port and the JAX package.

A module-scoped fixture starts two worker processes once (this file run as
a script, ``python tests/test_torch_distributed_pipeline.py <rank> <world>
<port> <dir>``).  They join a gloo group at 127.0.0.1 and run every case of
``CASES`` on meshes made with ``devices=["cpu"]``, two or four shards per
rank, so that an exchange mixes same-process copies with cross-process
slabs.  Each case returns its arrays (a block's under ``<name>.<shard>``,
this rank's blocks only) and its replicated numbers; the worker saves them.
The pytest process runs the same case on the one-process mesh of the same
shape.

Gates: every rank's arrays and numbers BITWISE the one-process run's (the
same block steps, every global sum added in shard order, the advection's
all-reduce exact), the scalar cotangents and the vertex gradient included
(both paths add the shards' vertex cotangents in shard order,
``parallel.mesh.replicate``), and the same on every rank; the pipeline's
gathered fields on rank 0 only, its files written by rank 0 alone and
byte-equal; the resumed solves bitwise the uninterrupted one-process
solves; the float64 run within 1e-9 of the JAX package's ``run_mesh`` on
the same init (ROADMAP H8); the vertex gradient within atol 1e-4 / rtol
1e-3 of the JAX package's sharded gradient (the one-process comparison's
gates, ``tests/test_torch_differentiable.py``).  The one-process
references run on one CPU thread, as the ranks do: a float32 sum splits
its reduction by the thread count.
"""

import contextlib
import json
import os
import socket
import subprocess
import sys
from functools import partial

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if __name__ == "__main__":
    sys.path.insert(0, ROOT)

from levelsetfortran_tpu_torch.config import LevelSetConfig  # noqa: E402
from levelsetfortran_tpu_torch.grid.grid import Grid3D  # noqa: E402
from levelsetfortran_tpu_torch.models.analytic import \
    icosphere_mesh  # noqa: E402
from levelsetfortran_tpu_torch.parallel import distributed  # noqa: E402
from levelsetfortran_tpu_torch.parallel import halo  # noqa: E402
from levelsetfortran_tpu_torch.parallel import sharded as sh  # noqa: E402
from levelsetfortran_tpu_torch.parallel.mesh import (  # noqa: E402
    make_mesh, split_blocks)
from levelsetfortran_tpu_torch.pipeline import run as port_run  # noqa: E402
from levelsetfortran_tpu_torch.solvers import checkpointed  # noqa: E402
from levelsetfortran_tpu_torch.utils.checkpoint import \
    FieldCheckpointer  # noqa: E402

torch.set_num_threads(1)

WORLD = 2
#: The workers' timeout (their cases take ~30-40 s; starting takes ~5 s).
TIMEOUT_S = 240
GSHAPE = (32, 16, 16)

#: run_mesh configurations: (mesh shape, config keywords).  The float32
#: runs take the default routing (narrow band, stop tests on), bfloat16
#: the dense plain route with the stop tests on, the float64 run the JAX
#: comparison's configuration (its run_mesh takes every one of
#: the 8 virtual devices, so (2, 2, 2)); "dense" is the checkpointed runs'
#: plain twin (dense solvers, so chunks change nothing, and a reinit that
#: converges after 8 steps).
BASE = dict(dx=0.1, pad_cells=6, reinit_iters=40, reinit_tol=1e-4,
            minmax_iters=8, minmax_tol=0.0, advect_iters=10,
            final_reinit_iters=4)
RUNS = {
    "f32-221": ((2, 2, 1), dict(BASE)),
    "f32-411": ((4, 1, 1), dict(BASE)),
    "f64-222": ((2, 2, 2), dict(dx=0.1, pad_cells=4, reinit_iters=12,
                                reinit_tol=0.0, minmax_iters=6,
                                minmax_tol=0.0, advect_iters=20,
                                final_reinit_iters=4, narrow_band="off",
                                dtype=torch.float64)),
    "dense-221": ((2, 2, 1), dict(BASE, narrow_band="off", reinit_tol=2e-4)),
    # bfloat16 slabs between the ranks (the plain route, dense solvers)
    "bf16-221": ((2, 2, 1), dict(BASE, dtype=torch.bfloat16)),
}
CK_CHUNK = 3
MESHES = ((2, 2, 1), (4, 1, 1))
PIPE_FIELDS = ("phi_init", "phi_smoothed", "phi_final")
KW = dict(eye=(0.0, -3.0, 0.0), target=(0.0, 0.0, 0.0), reinit_steps=5,
          minmax_steps=3, height=12, width=12, n_march_steps=48)


def _tag(shape):
    return "".join(map(str, shape))


def field(gshape=GSHAPE, seed=0, dtype=np.float32):
    """A distorted sphere, ``2 (|x| - 0.6)`` on ``linspace(-1, 1)`` points,
    with seeded noise of 1e-3."""
    xs = [np.linspace(-1.0, 1.0, g) for g in gshape]
    gx, gy, gz = np.meshgrid(*xs, indexing="ij")
    noise = np.random.default_rng(seed).standard_normal(gshape)
    return (2.0 * (np.sqrt(gx ** 2 + gy ** 2 + gz ** 2) - 0.6)
            + 1e-3 * noise).astype(dtype)


def _blocks_out(out, name, blocks):
    for i, b in enumerate(blocks):
        if b is not None:
            out[f"{name}.{i}"] = b.detach().numpy()


@contextlib.contextmanager
def solver_rms():
    """Record ``(iterations, rms)`` of every ShardedLevelSet solve."""
    seen = []
    real = {n: getattr(sh.ShardedLevelSet, n) for n in ("reinit",
                                                         "minmax_flow")}

    def wrap(fn):
        def solve(self, *a, **k):
            res = fn(self, *a, **k)
            seen.append(res[1:])
            return res
        return solve

    for n, fn in real.items():
        setattr(sh.ShardedLevelSet, n, wrap(fn))
    try:
        yield seen
    finally:
        for n, fn in real.items():
            setattr(sh.ShardedLevelSet, n, fn)


def run_case(name, mesh, out_dir, shared=None, checkpoint_dir=None):
    """One pipeline run: its replicated numbers, the solvers' RMS and (on
    the primary) the gathered fields; it writes its files into
    ``out_dir``."""
    mesh_shape, kw = RUNS[name]
    assert mesh.shape == mesh_shape
    cfg = LevelSetConfig(device="cpu", mesh_shape=mesh_shape,
                         checkpoint_dir=checkpoint_dir,
                         checkpoint_chunk=CK_CHUNK, **kw)
    ball = icosphere_mesh(radius=0.5, subdivisions=1)
    with solver_rms() as rms:
        res = port_run.run_mesh(ball, cfg, out_dir=out_dir, base="ball",
                                write_outputs=True)
    out = {"advected": res.advected,
           "counts": np.array([res.reinit_iters, res.minmax_iters,
                               res.reinit_diverged, res.minmax_diverged]),
           "asymptotic_error": np.float64(res.asymptotic_error),
           "rms": np.array([r for _, r in rms]),
           "solves": np.array([n for n, _ in rms])}
    for f in PIPE_FIELDS:
        if getattr(res, f) is not None:
            out[f] = getattr(res, f)
    return out


def resumable_case(kind, mesh, out_dir, shared):
    """A resumable solve stopped after two chunks of 2 steps, then resumed
    from a fresh checkpointer to 8 steps, its checkpoints in ``shared``."""
    phi = torch.from_numpy(field())
    dx = 2.0 / (GSHAPE[0] - 1)
    s = sh.ShardedLevelSet(mesh, GSHAPE, dx)
    blocks = s.device_put(phi)
    fn, step = ((checkpointed.reinit_resumable_sharded, 0.1 * dx)
                if kind == "reinit" else
                (checkpointed.minmax_resumable_sharded, 0.05 * dx * dx))
    d = os.path.join(shared, f"resumable-{kind}-{_tag(mesh.shape)}")
    part = fn(s, blocks, step, 4, 0.0, ckpt=FieldCheckpointer(d), chunk=2)
    res = fn(s, blocks, step, 8, 0.0, ckpt=FieldCheckpointer(d), chunk=2)
    out = {"counts": np.array([part.iterations, res.iterations,
                               res.resumed_from, res.final_rms == 0])}
    _blocks_out(out, "phi", res.phi)
    return out


def fixed_case(kind, mesh, out_dir, shared):
    """The differentiable sharded solver: forward blocks, the blocks'
    cotangents for a normal upstream cotangent, the scalar cotangents."""
    phi = torch.from_numpy(field())
    w = torch.from_numpy(np.random.default_rng(5).standard_normal(
        GSHAPE).astype(np.float32))
    dx = 2.0 / (GSHAPE[0] - 1)
    blocks = [None if b is None else b.requires_grad_(True)
              for b in split_blocks(mesh, phi)]
    if kind == "reinit":
        scalars = [torch.tensor(v, dtype=torch.float64, requires_grad=True)
                   for v in (dx, 0.1 * dx)]
        outs = sh.reinit_fixed_sharded(mesh, blocks, *scalars, 3)
    else:
        scalars = [torch.tensor(v, dtype=torch.float64, requires_grad=True)
                   for v in (dx, 0.05 * dx * dx)]
        outs = sh.minmax_fixed_sharded(mesh, blocks, *scalars, 3)
    loss = sum(torch.sum(wb * o) for wb, o in zip(split_blocks(mesh, w), outs)
               if o is not None)
    loss.backward()
    out = {"scalars": np.array([float(t.grad) for t in scalars])}
    _blocks_out(out, "out", outs)
    _blocks_out(out, "grad", [None if b is None else b.grad for b in blocks])
    return out


def octahedron(scale=0.7):
    v = scale * np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                          [0, 0, 1], [0, 0, -1]], np.float64)
    f = np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
                  [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]], np.int32)
    return v, f


def render_grid(n=24, half=1.2):
    return Grid3D(shape=(n, n, n), origin=(-half,) * 3, dx=2 * half / (n - 1))


def render_case(mesh, out_dir, shared):
    """``render_from_vertices(mesh=)`` and ``image_loss_and_vertex_grad``
    on the octahedron of ``tests/test_torch_differentiable.py``."""
    from levelsetfortran_tpu_torch import (image_loss_and_vertex_grad,
                                           render_from_vertices)
    v, f = octahedron()
    vt = torch.tensor(v, dtype=torch.float32)
    img = render_from_vertices(vt, f, render_grid(), mesh=mesh, **KW).image
    loss, grad = image_loss_and_vertex_grad(vt, f, render_grid(),
                                            torch.zeros((12, 12)),
                                            mesh=mesh, **KW)
    return {"image": img.detach().numpy(), "loss": loss.numpy(),
            "grad": grad.numpy()}


def halo_case(mesh, out_dir, shared):
    """The periodic exchange (width 4, and (3, 2, 1)) and the transpose of
    the exchange (width (2, 3, 1)) on seeded blocks and cotangents."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal(GSHAPE).astype(np.float32))
    blocks = split_blocks(mesh, x)
    out = {}
    for tag, width in (("w4", 4), ("w321", (3, 2, 1))):
        _blocks_out(out, f"periodic-{tag}",
                    halo.halo_exchange(blocks, width, mesh, periodic=True))
    width = (2, 3, 1)
    b = mesh.block_shape(GSHAPE)
    cots = [torch.from_numpy(rng.standard_normal(tuple(
        n + 2 * w for n, w in zip(b, width))).astype(np.float32))
        for _ in range(mesh.n_shards)]
    cots = [c if mesh.is_local(i) else None for i, c in enumerate(cots)]
    _blocks_out(out, "transpose",
                halo.halo_exchange_transpose(cots, width, mesh))
    return out


def advect_case(mesh, out_dir, shared):
    """``advect_nodes_sharded``: 200 seeded nodes, 10 iterations."""
    grid = Grid3D(shape=GSHAPE, origin=(-1.0, -0.5, -0.5), dx=2.0 / 31)
    blocks = split_blocks(mesh, torch.from_numpy(field()))
    nodes = torch.from_numpy(np.random.default_rng(9).uniform(
        (-0.9, -0.4, -0.4), (0.9, 0.4, 0.4), (200, 3)).astype(np.float32))
    res = sh.advect_nodes_sharded(mesh, blocks, grid, nodes, grid.dx, 10)
    return {"positions": res.positions.numpy(),
            "phi_surf": res.phi_surf.numpy()}


#: case name -> (mesh shape, function of (mesh, out_dir, shared)): a
#: pipeline run writes into ``out_dir`` (its own per rank), a checkpoint
#: goes into ``shared`` (one directory that both ranks see)
CASES = {f"run-{n}": (RUNS[n][0], partial(run_case, n)) for n in RUNS}
for _s in MESHES:
    CASES.update({
        f"resumable-reinit-{_tag(_s)}": (_s, partial(resumable_case,
                                                     "reinit")),
        f"resumable-minmax-{_tag(_s)}": (_s, partial(resumable_case,
                                                     "minmax")),
        f"fixed-reinit-{_tag(_s)}": (_s, partial(fixed_case, "reinit")),
        f"fixed-minmax-{_tag(_s)}": (_s, partial(fixed_case, "minmax")),
        f"advect-{_tag(_s)}": (_s, advect_case)})
for _s in MESHES + ((2, 1, 1),):
    CASES[f"halo-{_tag(_s)}"] = (_s, halo_case)
CASES["render-221"] = ((2, 2, 1), render_case)


def worker(rank, world, port, out_dir):
    """One rank: every case, its arrays saved; then the checkpointed
    pipeline runs, the file names each save wrote."""
    assert distributed.init_distributed(f"127.0.0.1:{port}", world, rank,
                                        device="cpu")
    written = []
    real_save = torch.save

    def save(obj, path, *a, **k):
        written.append(os.path.relpath(path, out_dir))
        return real_save(obj, path, *a, **k)

    torch.save = save
    shared = os.path.join(out_dir, "shared")
    for name, (shape, fn) in CASES.items():
        res = fn(make_mesh(shape, ["cpu"]),
                 os.path.join(out_dir, f"{name}-out-r{rank}"), shared)
        np.savez(os.path.join(out_dir, f"{name}-{rank}.npz"), **res)
    ck = os.path.join(shared, "pipeline-ck")
    for tag in ("ck", "ck-again"):
        res = run_case("dense-221", make_mesh((2, 2, 1), ["cpu"]),
                       os.path.join(out_dir, f"{tag}-out-r{rank}"),
                       checkpoint_dir=ck)
        np.savez(os.path.join(out_dir, f"{tag}-{rank}.npz"), **res)
    torch.save = real_save
    with open(os.path.join(out_dir, f"written-{rank}.json"), "w") as f:
        json.dump(written, f)
    torch.distributed.destroy_process_group()
    print(json.dumps({"done": rank}), flush=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_workers(script, out, world=WORLD, timeout=TIMEOUT_S):
    """Run ``script <rank> <world> <port> <out>`` as ``world`` processes
    (one CPU thread each) and wait for them; a rank that fails or outlives
    ``timeout`` seconds fails the caller with its log."""
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    logs = [open(out / f"rank{r}.log", "w+") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, script, str(r), str(world), str(port), str(out)],
        cwd=ROOT, env=env, stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(world)]
    try:
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, f) in enumerate(zip(procs, logs)):
        f.seek(0)
        text = f.read()
        f.close()
        assert p.returncode == 0, f"rank {r} rc={p.returncode}:\n{text[-3000:]}"


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Start the two workers once; their output directory."""
    out = tmp_path_factory.mktemp("ranks")
    run_workers(__file__, out)
    return out


def _saved(out, name):
    return [dict(np.load(out / f"{name}-{r}.npz")) for r in range(WORLD)]


def _against_one(saved, one):
    """Every rank's arrays bitwise the one-process run's; the blocks of the
    ranks together are the one-process blocks."""
    seen = set()
    for rank_out in saved:
        for k, v in rank_out.items():
            np.testing.assert_array_equal(v, one[k], err_msg=k)
            seen.add(k)
    assert seen == set(one), set(one) ^ seen


def _one_process(name, tmp_path):
    shape, fn = CASES[name]
    return fn(make_mesh(shape, ["cpu"]), str(tmp_path / "out"),
              str(tmp_path))


@pytest.mark.parametrize("name", [n for n in CASES
                                  if not n.startswith("run-")])
def test_two_processes_equal_one(ranks, name, tmp_path):
    """The periodic exchange, its transpose, the advection, the resumable
    and the differentiable sharded solvers and the render: every rank
    bitwise the one-process run."""
    saved = _saved(ranks, name)
    one = _one_process(name, tmp_path)
    _against_one(saved, one)
    if name.startswith("fixed") or name.startswith("render"):
        key = "scalars" if name.startswith("fixed") else "grad"
        np.testing.assert_array_equal(saved[0][key], saved[1][key])
    if name.startswith("resumable"):
        assert list(saved[0]["counts"][:3]) == [4, 8, 4]
        kind = name.split("-")[1]
        m = make_mesh(CASES[name][0], ["cpu"])
        dx = 2.0 / (GSHAPE[0] - 1)
        s = sh.ShardedLevelSet(m, GSHAPE, dx)
        blocks = s.device_put(torch.from_numpy(field()))
        if kind == "reinit":      # the sign source frozen at the input
            whole, n, _ = s.reinit(blocks, 0.1 * dx, 8, 0.0)
        else:
            whole, n, _ = s.minmax_flow(blocks, 0.05 * dx * dx, 8, 0.0)
        assert n == 8
        for i, b in enumerate(whole):        # the uninterrupted solve
            np.testing.assert_array_equal(one[f"phi.{i}"], b.numpy())


@pytest.mark.parametrize("run", list(RUNS))
def test_run_mesh_under_a_group_equals_one_process(ranks, run, tmp_path):
    """``run_mesh`` with mesh_shape on two ranks: every rank's nodes,
    counts, RMS and asymptotic error bitwise the one-process run; rank 0's
    gathered fields too and rank 1's None; rank 0's files byte-equal and
    rank 1 wrote none."""
    name = f"run-{run}"
    saved = _saved(ranks, name)
    one = _one_process(name, tmp_path)
    assert all(f not in saved[1] for f in PIPE_FIELDS)
    assert all(f in saved[0] for f in PIPE_FIELDS)
    _against_one(saved, one)
    files = sorted(os.listdir(tmp_path / "out"))
    assert files == ["ball.s3d", "signedDistanceFunction.vti",
                     "smoothedDistanceFunction.vti"]
    for f in files:
        with open(tmp_path / "out" / f, "rb") as a, \
                open(ranks / f"{name}-out-r0" / f, "rb") as b:
            assert a.read() == b.read(), f
    assert not os.path.exists(ranks / f"{name}-out-r1")


def test_group_run_matches_jax_sharded_run(ranks, monkeypatch, tmp_path,
                                           eight_devices):
    """The float64 group run's gathered fields within 1e-9 of the JAX
    package's ``run_mesh`` on (2, 2, 2), the same init handed to both
    (``test_torch_sharded_pipeline.py``'s protocol)."""
    import jax.numpy as jnp
    import levelsetfortran_tpu.ops.init_sign as jax_init
    import levelsetfortran_tpu.pipeline.run  # noqa: F401
    from levelsetfortran_tpu.config import LevelSetConfig as JaxConfig
    from levelsetfortran_tpu.models.analytic import \
        icosphere_mesh as jax_icosphere
    from levelsetfortran_tpu_torch.parallel.mesh import gather_blocks
    jax_run = sys.modules["levelsetfortran_tpu.pipeline.run"]
    shape, kw = RUNS["f64-222"]
    jcfg = JaxConfig(**{k: v for k, v in kw.items() if k != "dtype"},
                     dtype=jnp.float64, mesh_shape=shape)
    inits = []
    real = port_run.signed_distance_init_sharded
    monkeypatch.setattr(port_run, "signed_distance_init_sharded",
                        lambda *a, **k: inits.append(real(*a, **k))
                        or inits[-1])
    port_run.run_mesh(icosphere_mesh(radius=0.5, subdivisions=1),
                      LevelSetConfig(device="cpu", mesh_shape=shape, **kw))
    whole = gather_blocks(make_mesh(shape, ["cpu"]), inits[0])
    monkeypatch.setattr(jax_init, "signed_distance_init_sharded",
                        lambda *a, **k: jnp.asarray(whole.numpy()))
    ref = jax_run.run_mesh(jax_icosphere(radius=0.5, subdiv=1), jcfg)
    got = _saved(ranks, "run-f64-222")[0]
    assert list(got["counts"][:2]) == [ref.reinit_iters, ref.minmax_iters]
    for f in PIPE_FIELDS + ("advected",):
        np.testing.assert_allclose(got[f], getattr(ref, f), rtol=0,
                                   atol=1e-9, err_msg=f)


def test_checkpointed_run_under_a_group(ranks):
    """``run_mesh`` with checkpoint_dir on two ranks: bitwise the plain
    group run; each rank wrote its own blocks' files only, rank 0 the
    metadata; every step directory complete.  Run again on the same
    directory, the converged reinit stage takes one more step (ROADMAP
    H15) and the min/max stage is restored whole."""
    plain, ck, again = (_saved(ranks, n) for n in ("run-dense-221", "ck",
                                                   "ck-again"))
    per_chunk = ("rms", "solves")          # the solver runs once per chunk
    for r in range(WORLD):
        assert set(ck[r]) == set(plain[r])
        for k in set(ck[r]) - set(per_chunk):
            np.testing.assert_array_equal(ck[r][k], plain[r][k], err_msg=k)
    assert plain[0]["counts"][0] == 8               # the reinit converged
    for r in range(WORLD):
        assert again[r]["counts"][0] == 9 and \
            again[r]["counts"][1] == plain[r]["counts"][1]
        for k in ("phi_smoothed", "phi_final", "advected"):
            if k in plain[r]:
                np.testing.assert_array_equal(again[r][k], plain[r][k])
    ckdir = ranks / "shared" / "pipeline-ck"
    steps = {s: sorted(os.listdir(ckdir / s)) for s in ("reinit", "minmax")}
    assert steps == {"reinit": ["6", "8", "9"], "minmax": ["3", "6", "8"]}
    for stage, names in steps.items():
        for n in names:
            assert sorted(os.listdir(ckdir / stage / n)) == [
                "meta.json", "phi.0.pt", "phi.1.pt", "phi.2.pt", "phi.3.pt"]
    # every checkpoint of the group: each rank wrote its own blocks' files
    # only, and every step directory is complete (no temporary left)
    written = []
    for r in range(WORLD):
        with open(ranks / f"written-{r}.json") as f:
            written.append(json.load(f))
    for d in sorted(os.listdir(ranks / "shared")):
        for r, own in enumerate(((0, 1), (2, 3))):
            assert {os.path.basename(p) for p in written[r]
                    if p.startswith(os.path.join("shared", d))} == {
                f"phi.{i}.pt" for i in own}, (d, r)
        stages = (["reinit", "minmax"] if d == "pipeline-ck" else [""])
        for stage in stages:
            top = ranks / "shared" / d / stage
            for step in os.listdir(top):
                assert step.isdigit(), (d, step)
                assert sorted(os.listdir(top / step)) == [
                    "meta.json", "phi.0.pt", "phi.1.pt", "phi.2.pt",
                    "phi.3.pt"]


def test_group_render_matches_jax_sharded_render(ranks, eight_devices):
    """The two ranks' vertex gradient against the JAX package's sharded
    ``image_loss_and_vertex_grad`` on (2, 2, 1) virtual devices."""
    import jax.numpy as jnp
    from levelsetfortran_tpu.grid.grid import Grid3D as JGrid
    from levelsetfortran_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from levelsetfortran_tpu.pipeline import differentiable as jdiff
    v, f = octahedron()
    g = render_grid()
    lj, gj = jdiff.image_loss_and_vertex_grad(
        jnp.asarray(v, jnp.float32), jnp.asarray(f),
        JGrid(shape=g.shape, origin=g.origin, dx=g.dx),
        jnp.zeros((12, 12), jnp.float32), use_pallas=False,
        mesh=jax_make_mesh((2, 2, 1), eight_devices[:4]), **KW)
    gj = np.asarray(gj)
    assert np.abs(gj).max() > 0
    for got in _saved(ranks, "render-221"):
        np.testing.assert_allclose(float(got["loss"]), float(lj), rtol=1e-4)
        np.testing.assert_allclose(got["grad"], gj, atol=1e-4, rtol=1e-3)


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
