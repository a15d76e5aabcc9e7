"""K7, the init's selection scan (``ops/init_cuda.py``), on the CPU: the
host-side packing of the bucketed candidate tables into scan rows, the
plain version over rows against the per-bucket scans it replaces, the
restructured init (the exact re-evaluation in chunks) against the JAX
package, values and vertex gradient, and the route: float32 takes the
wrapper, bfloat16 and float64 the plain version, and off the CPU the
wrapper launches K7 or raises.  K7 itself runs on the card only
(``chip_smoke.py`` phase 17 holds it against the plain version there).

Tolerances: the rows and the argmin indices are held equal; the
accumulator (a sum over each tile, whose padding differs between the two
scans) to 1e-5 of its largest magnitude; the field against the JAX
package as ``test_torch_init.py`` holds it (float32 atol 1e-5, float64
1e-10); the float64 vertex gradient against ``jax.grad`` to 1e-9.
"""

import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from levelsetfortran_tpu.grid import grid as jgrid
from levelsetfortran_tpu.ops import init_sign as jinit
from levelsetfortran_tpu_torch import cuda_build
from levelsetfortran_tpu_torch.grid import grid as tgrid
from levelsetfortran_tpu_torch.models.analytic import (icosphere_mesh,
                                                       two_cubes_mesh)
from levelsetfortran_tpu_torch.ops import init_cuda
from levelsetfortran_tpu_torch.ops import init_sign as tinit

torch.set_num_threads(1)
MESHES = {"two_cubes": two_cubes_mesh,
          "icosphere2": lambda: icosphere_mesh(subdivisions=2)}
DTYPES = {"float64": (jnp.float64, torch.float64, 1e-10),
          "float32": (jnp.float32, torch.float32, 1e-5)}


def _culled(mesh, dx=0.05, tile=128):
    m = MESHES[mesh]()
    grid = tgrid.from_surface(m.vertices, dx, 3)
    return m, grid, tinit.build_init_culling(grid, m.vertices, m.elements,
                                             tile=tile)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_pack_rows_matches_the_bucket_tables(mesh):
    m, _, c = _culled(mesh)
    E = m.n_elems
    rows = init_cuda.pack_rows(c.cands, c.bidxs, E)
    table = {int(b): row for cand, ids in zip(c.cands, c.bidxs)
             for b, row in zip(ids, cand)}
    assert sorted(rows.bidx.tolist()) == sorted(table)
    assert (np.diff(rows.counts) <= 0).all()       # longest rows first
    assert rows.pairs_per_point == sum(int((x != E).sum()) for x in c.cands)
    width = max(x.shape[1] for x in c.cands)
    padded = rows.table(slice(None), width, E)
    for r, b in enumerate(rows.bidx):
        live = table[int(b)][table[int(b)] != E]
        n = rows.counts[r]
        np.testing.assert_array_equal(
            rows.flat[rows.offsets[r]:rows.offsets[r] + n], live)
        want = np.full(width, E)
        want[:table[int(b)].size] = table[int(b)]
        np.testing.assert_array_equal(padded[r], want)


def test_pack_rows_keeps_a_row_to_its_last_candidate():
    """A sentinel inside a row stays (the row's tiles start where the
    table's do); trailing sentinels go; an empty row keeps nothing."""
    E = 9
    cands = (np.array([[1, E, 3, E, E], [4, 5, 6, 7, 8], [E] * 5],
                      np.int32),)
    rows = init_cuda.pack_rows(cands, (np.array([7, 2, 5], np.int32),), E)
    np.testing.assert_array_equal(rows.bidx, [2, 7, 5])
    np.testing.assert_array_equal(rows.counts, [5, 3, 0])
    np.testing.assert_array_equal(rows.flat, [1, E, 3, 4, 5, 6, 7, 8])
    np.testing.assert_array_equal(rows.table(slice(None), 6, E),
                                  [[4, 5, 6, 7, 8, E], [1, E, 3, E, E, E],
                                   [E] * 6])
    dense = init_cuda.dense_rows(4, 6)
    assert dense.flat is None and dense.pairs_per_point == 24
    np.testing.assert_array_equal(dense.table(slice(1, 3), 8, 6),
                                  [[0, 1, 2, 3, 4, 5, 6, 6]] * 2)


def _scan_inputs(m, grid, rows, nblocks, dtype=torch.float32, block=16):
    v = torch.as_tensor(m.vertices, dtype=dtype)
    tri = v[torch.as_tensor(m.elements, dtype=torch.long)]
    tri_s = torch.cat([tri, torch.full((1, 3, 3), 1e30, dtype=dtype)])
    _, ang = tinit._triangle_features(tri_s)
    nby, nbz = nblocks[1], nblocks[2]
    b = rows.bidx
    borig = torch.as_tensor(np.stack([b // (nby * nbz), (b // nbz) % nby,
                                      b % nbz], -1) * block)
    pts = torch.tensor(grid.origin, dtype=dtype) + float(np.float32(
        grid.dx) if dtype == torch.float32 else grid.dx) * (
        borig[:, None, :] + tinit._block_offsets(block, "cpu")[None]
    ).to(dtype)
    return pts, pts.mean(dim=1), tri_s, ang


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_rows_scan_equals_the_bucket_scans(mesh, dtype):
    """The plain version over scan rows (groups of rows by count, each
    padded to its group's longest) against the scan it replaces: each
    bucket's whole table at once, on the same points and shifts."""
    m, grid, c = _culled(mesh)
    E = m.n_elems
    rows = init_cuda.pack_rows(c.cands, c.bidxs, E)
    pts, shift, tri_s, ang = _scan_inputs(m, grid, rows, c.nblocks, dtype)
    best, acc = init_cuda.select_rows_plain(pts, shift, tri_s, ang, rows,
                                            tile=128)
    where = {int(b): r for r, b in enumerate(rows.bidx)}
    for cand, ids in zip(c.cands, c.bidxs):
        r = torch.as_tensor([where[int(b)] for b in ids])
        idx = torch.as_tensor(cand, dtype=torch.long)
        b_ref, a_ref = init_cuda._select_scan(pts[r], tri_s[idx], ang[idx],
                                              128, shift=shift[r])
        assert torch.equal(best[r], b_ref)
        scale = float(a_ref.abs().max())
        assert float((acc[r] - a_ref).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("culling", ["auto", None])
def test_init_in_chunks_matches_jax(mesh, dtype, culling, monkeypatch):
    """The exact re-evaluation in chunks of three culling blocks (the
    card's are 2048) against the JAX package's init."""
    monkeypatch.setattr(tinit, "_EXACT_POINTS", 3 * 16 ** 3)
    m = MESHES[mesh]()
    jdt, tdt, atol = DTYPES[dtype]
    grid = tgrid.from_surface(m.vertices, 0.1, 3)
    ref = jinit.signed_distance_init(
        jgrid.Grid3D(grid.shape, grid.origin, grid.dx),
        jnp.asarray(m.vertices, jdt), jnp.asarray(m.elements), dtype=jdt,
        culling=culling)
    out = tinit.signed_distance_init(grid, m.vertices, m.elements,
                                     dtype=tdt, culling=culling)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=atol)


def test_init_vertex_gradient_matches_jax(monkeypatch):
    """d(sum(w * phi))/d(vertices) in float64, the port's culled init in
    chunks against ``jax.grad`` of the JAX package's (dense under the
    trace); the grid is offset so that no point lies on the surface,
    where the sign is a tie."""
    monkeypatch.setattr(tinit, "_EXACT_POINTS", 2 * 16 ** 3)
    m = icosphere_mesh(subdivisions=2)
    g0 = tgrid.from_surface(m.vertices, 0.1, 3)
    grid = tgrid.Grid3D(g0.shape, tuple(o + 0.0123 for o in g0.origin),
                        g0.dx)
    w = np.random.default_rng(7).standard_normal(grid.shape)
    jg = jgrid.Grid3D(grid.shape, grid.origin, grid.dx)

    def jloss(v):
        phi = jinit.signed_distance_init(jg, v, jnp.asarray(m.elements),
                                         dtype=jnp.float64)
        return jnp.sum(phi * w)

    ref = jax.grad(jloss)(jnp.asarray(m.vertices, jnp.float64))
    v = torch.tensor(m.vertices, dtype=torch.float64, requires_grad=True)
    phi = tinit.signed_distance_init(grid, v, m.elements,
                                     dtype=torch.float64)
    (torch.from_numpy(w) * phi).sum().backward()
    np.testing.assert_allclose(v.grad.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-9)


class _Calls:
    def __init__(self, monkeypatch, module, *names):
        self.n = {k: 0 for k in names}
        for k in names:
            real = getattr(module, k)

            def wrap(*a, _real=real, _k=k, **kw):
                self.n[_k] += 1
                return _real(*a, **kw)

            monkeypatch.setattr(module, k, wrap)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
@pytest.mark.parametrize("culling", ["auto", None])
def test_init_routes_by_dtype(dtype, culling, monkeypatch):
    """float32 goes through K7's wrapper (which on the CPU runs the plain
    version); bfloat16 and float64 call the plain version directly, as the
    JAX package sends them to its jnp path."""
    calls = _Calls(monkeypatch, init_cuda, "select_rows",
                   "select_rows_plain")
    m = two_cubes_mesh()
    grid = tgrid.from_surface(m.vertices, 0.2, 2)
    out = tinit.signed_distance_init(grid, m.vertices, m.elements,
                                     dtype=dtype, culling=culling)
    assert out.dtype == dtype and torch.isfinite(out.float()).all()
    f32 = dtype == torch.float32
    assert calls.n == {"select_rows": int(f32), "select_rows_plain": 1}


@contextlib.contextmanager
def _no_card(monkeypatch, module):
    """Meta tensors stand in for the card's: the launch records its entry
    and arguments and raises as a launch with no library would; the plain
    versions fail if called."""
    launched = []

    def launch(name, *args):
        launched.append((name, args))
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(cuda_build, "launch", launch)
    monkeypatch.setattr(module, "on_device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    yield launched


@pytest.mark.parametrize("dense", [True, False])
def test_select_rows_launches_or_raises_off_the_cpu(dense, monkeypatch):
    R, P, E = 3, 8, 5
    rows = (init_cuda.dense_rows(R, E) if dense else init_cuda.pack_rows(
        (np.array([[0, 1, 2], [3, 4, E], [2, E, E]], np.int32),),
        (np.arange(R, dtype=np.int32),), E))

    def args(dtype):
        return (torch.empty((R, P, 3), dtype=dtype, device="meta"),
                torch.empty((R, 3), dtype=dtype, device="meta"),
                torch.empty((E + 1, 3, 3), dtype=dtype, device="meta"),
                torch.empty((E + 1, 3), dtype=dtype, device="meta"), rows)

    monkeypatch.setattr(init_cuda, "select_rows_plain",
                        lambda *a, **k: pytest.fail("fell back"))
    with _no_card(monkeypatch, init_cuda) as launched:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            init_cuda.select_rows(*args(torch.float32), tile=512)
        ((name, a),) = launched
        assert name == "lsf_init_select_f32"
        assert len(a) == len(cuda_build.SIGNATURES[name])
        assert (a[4] is None) == dense and (a[5] is None) == dense
        assert a[7:10] == (R, P, 512)
        with pytest.raises(TypeError, match="float32 only"):
            init_cuda.select_rows(*args(torch.float64), tile=512)
        with pytest.raises(ValueError, match="tile"):
            init_cuda.select_rows(*args(torch.float32), tile=4096)
        assert len(launched) == 1


@pytest.mark.parametrize("culling", ["auto", None])
def test_init_stage_times(culling, monkeypatch):
    """With ``stage_times`` a dict the init adds its stages' seconds to it
    (the culling build only where it builds one); by default, None, it
    keeps no clock."""
    m = two_cubes_mesh()
    grid = tgrid.from_surface(m.vertices, 0.2, 2)
    times = {}
    monkeypatch.setattr(tinit, "stage_times", times)
    a = tinit.signed_distance_init(grid, m.vertices, m.elements,
                                   culling=culling)
    want = {"select", "exact"} | ({"culling"} if culling else set())
    assert set(times) == want and all(v >= 0.0 for v in times.values())
    monkeypatch.setattr(tinit, "stage_times", None)
    b = tinit.signed_distance_init(grid, m.vertices, m.elements,
                                   culling=culling)
    assert torch.equal(a, b) and set(times) == want
