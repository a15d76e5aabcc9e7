"""The benchmark cell ``icosphere5_256_refinit.run`` on the CPU, at small
sizes: the port's pipeline under ``init_mode="reference"`` against the
cell's plain reference (``h100bench/reference/refinit.py``), within the
cell's limits; the init's field against the reference's; the spans and
counters the cell's metrics read; and a planted fault the comparison
catches.

The bodies are the cell's (``icosphere`` from ``h100bench/meshes.py``,
scaled and turned from a seed) at 2 subdivisions on a ~35^3 grid; the
advection and the final reinit are cut short to keep a mesh to seconds.
"""

import glob
import json
import math
import os

import numpy as np
import pytest
import torch

from h100bench import catalog, compare, meshes
from h100bench.reference import geometry, refinit
from h100bench.roofline import k9
from levelsetfortran_tpu_torch.config import LevelSetConfig
from levelsetfortran_tpu_torch.grid import grid as gridmod
from levelsetfortran_tpu_torch.io.stl import read_stl
from levelsetfortran_tpu_torch.ops import init_sign
from levelsetfortran_tpu_torch.pipeline import run as port_run
from levelsetfortran_tpu_torch.utils import profiling

torch.set_num_threads(1)
CELL = "icosphere5_256_refinit.run"
LIMITS = catalog.limits(CELL)
BODY = {"generator": "icosphere", "subdivisions": 2, "radius": 1.0}
DX, PAD = 0.08, 4
#: The cell's settings with the advection and the final reinit cut short.
OVER = dict(init_mode="reference", advect_iters=50, final_reinit_iters=18)
SEEDS = (1, 2, 2 ** 31 + 11)
#: Points whose field value may differ from the reference's at a near-tie
#: of the nearest centroid (measured 0 on every seed here).
CAP_FIELD = 20


def _soup(seed):
    (s, axis, angle), = meshes.variants(seed, 1, [0.97, 1.03], 360.0)[:1]
    return meshes.transform(meshes.base_soup(BODY), s, axis, angle)


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """seed -> (soup, the port's mesh read from its STL file)."""
    tmp = tmp_path_factory.mktemp("refinit")
    made = {}

    def make(seed):
        if seed not in made:
            soup = _soup(seed)
            path = str(tmp / f"job{seed}.stl")
            meshes.write_stl(path, soup)
            made[seed] = soup, read_stl(path)
        return made[seed]
    return make


def _cfg(**kw):
    return LevelSetConfig(dx=DX, pad_cells=PAD, device="cpu",
                          **{**OVER, **kw})


def _numbers(res, want):
    """The numbers the cell's check compares (``entries/run_refinit.py``)."""
    return dict(
        phi_init_dx=compare.field_gap(res.phi_init, want["phi_init"], DX),
        phi_smoothed_dx=compare.field_gap(res.phi_smoothed,
                                          want["phi_smoothed"], DX),
        phi_final_dx=compare.field_gap(res.phi_final, want["phi_final"],
                                       DX),
        nodes_dx=compare.nodes_gap(res.advected, want["advected"], DX),
        iters_gap=float(max(abs(res.reinit_iters - want["reinit_iters"]),
                            abs(res.minmax_iters - want["minmax_iters"]))))


def _within(numbers):
    return {k: v for k, v in numbers.items() if not v <= LIMITS[k]}


_REFERENCE = {}


def _reference(seed):
    if seed not in _REFERENCE:
        _REFERENCE[seed] = refinit.run_mesh(_soup(seed), DX, PAD, OVER,
                                            "cpu")
    return _REFERENCE[seed]


@pytest.mark.parametrize("seed", SEEDS)
def test_run_mesh_within_the_cells_limits(job, seed):
    """float32: every number within the cell's limits, and the reinit's
    and the min/max flow's step counts equal."""
    _, mesh = job(seed)
    res = port_run.run_mesh(mesh, _cfg())
    want = _reference(seed)
    assert set(LIMITS) == set(_numbers(res, want))
    assert _within(_numbers(res, want)) == {}
    assert (res.reinit_iters, res.minmax_iters) == (
        want["reinit_iters"], want["minmax_iters"])
    assert 0 < res.reinit_iters < 10000


def test_run_mesh_float64_within_the_cells_limits(job):
    """float64, where every stage of the port runs dense: within the
    cell's limits of the float32 reference."""
    _, mesh = job(SEEDS[0])
    res = port_run.run_mesh(mesh, _cfg(dtype=torch.float64))
    assert res.phi_init.dtype == np.float64
    assert _within(_numbers(res, _reference(SEEDS[0]))) == {}


def _near_ties(pts, cen):
    """Whether each point's two nearest centroids lie within the float32
    rounding of the distance term (float64 squared distances)."""
    p, c = pts.double().numpy(), cen.double().numpy()
    d2 = np.sort(np.sum((p[:, None] - c[None]) ** 2, -1), axis=1)
    cn = np.max(np.sum(c * c, -1))
    scale = cn + 2 * np.sqrt(np.sum(p * p, -1) * cn)
    return d2[:, 1] - d2[:, 0] <= 16 * np.finfo(np.float32).eps * scale


@pytest.mark.parametrize("seed", SEEDS)
def test_init_field_matches_reference(job, seed):
    """The port's box equals the reference's, and its field the
    reference's but at near-ties of the nearest centroid, counted and
    capped."""
    soup, mesh = job(seed)
    verts, elems = geometry.soup_mesh(soup)
    grid = gridmod.from_surface(mesh.vertices, DX, PAD)
    rgrid = geometry.from_surface(verts, DX, PAD)
    assert grid.shape == rgrid.shape and grid.origin == rgrid.origin
    v32 = torch.as_tensor(mesh.vertices, dtype=torch.float32)
    box = refinit.subbox(rgrid, verts)
    assert init_sign.subbox_ranges(grid, v32.amin(0), v32.amax(0)) == box
    ours = init_sign.initialize_sign_field(grid, mesh.vertices,
                                           mesh.elements).numpy()
    want, n, _ = refinit.sign_field(rgrid, verts, elems, "cpu")
    want = want.numpy()
    outside = np.ones(grid.shape, bool)
    outside[tuple(slice(a, b + 1) for a, b in box)] = False
    assert np.all(ours[outside] == 1.0) and np.all(want[outside] == 1.0)
    off = np.argwhere(ours != want)
    assert len(off) <= CAP_FIELD, len(off)
    if len(off):
        pts = torch.as_tensor(np.asarray(grid.origin) + DX * off)
        cen = v32[torch.as_tensor(mesh.elements, dtype=torch.long)].mean(1)
        assert _near_ties(pts, cen).all()
    assert n == math.prod(b - a + 1 for a, b in box)


def test_subbox_matches_the_port():
    """The reference's box (float32 arithmetic on the float32 vertices)
    equals the port's over many scales, turns and spacings, where
    ``(lo - origin) / dx`` lands on a whole number of cells."""
    base = meshes.base_soup(BODY)
    for seed in range(40):
        for s, axis, angle in meshes.variants(seed, 4, [0.5, 1.7], 360.0):
            soup = meshes.transform(base, s, axis, angle)
            verts, _ = geometry.soup_mesh(soup)
            for dx, pad in ((0.00855, 10), (0.05, 3), (0.3, 0)):
                g = gridmod.from_surface(verts, dx, pad)
                v32 = torch.as_tensor(verts, dtype=torch.float32)
                assert init_sign.subbox_ranges(
                    g, v32.amin(0), v32.amax(0)) == refinit.subbox(
                        geometry.from_surface(verts, dx, pad), verts)


def _spans(logdir):
    (path,) = glob.glob(os.path.join(logdir, "*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("cat") == "user_annotation"
            and e.get("ph") == "X"]


def test_spans_and_counters(job, tmp_path):
    """Under a session: the init's three spans, the search and the sign
    inside the whole; ``init.centroid_pairs`` the roofline's count of the
    same mesh; ``reinit.steps`` the dense reinit's steps."""
    soup, mesh = job(SEEDS[0])
    with profiling.trace(str(tmp_path)):
        res = port_run.run_mesh(mesh, _cfg(reinit_iters=40))
        got = profiling.counters()
    spans = _spans(str(tmp_path))
    (whole,) = [e for e in spans if e["name"] == "lsf.init.reference"]
    for name in ("lsf.init.reference.nearest", "lsf.init.reference.sign"):
        (inner,) = [e for e in spans if e["name"] == name]
        assert whole["ts"] <= inner["ts"] and (
            inner["ts"] + inner["dur"] <= whole["ts"] + whole["dur"])
    points, centroids = k9.sizes(soup, DX, PAD)
    assert got["init.centroid_pairs"] == k9.pairs(soup, DX, PAD) == (
        points * centroids)
    assert got["init.reference_points"] == points
    assert centroids == mesh.n_elems
    assert got["reinit.steps"] == res.reinit_iters == 40


def test_planted_fault_flipped_triangle_is_caught(job, monkeypatch):
    """The triple product's sign flipped on one triangle: the points
    nearest its centroid take the wrong side, and the comparison fails."""
    _, mesh = job(SEEDS[0])
    bad = torch.as_tensor(mesh.vertices[mesh.elements[7]],
                          dtype=torch.float32)
    real = init_sign.orientation_sign

    def flipped(points, tri_verts):
        s = real(points, tri_verts)
        hit = (tri_verts == bad.to(tri_verts.dtype)).all(-1).all(-1)
        return torch.where(hit, -s, s)

    monkeypatch.setattr(init_sign, "orientation_sign", flipped)
    res = port_run.run_mesh(mesh, _cfg())
    assert _within(_numbers(res, _reference(SEEDS[0])))
