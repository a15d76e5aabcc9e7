"""The jobs come from the seed: the same seed gives the same jobs, another
seed other jobs of the same sizes, in the same order."""

import numpy as np
import pytest

from h100bench import jobs, meshes, run
from h100bench.reference import geometry


class _Ctx:
    def __init__(self, seed, config, traffic):
        self.seed, self.config, self.traffic = seed, config, traffic


CONFIG = {"body": {"generator": "icosphere", "subdivisions": 2}}
TRAFFIC = {"pool": 8, "scale": [0.97, 1.03], "rotate_deg": 360.0}


def test_seed_repeats_exactly():
    a, wa = jobs.soups(_Ctx(2 ** 31 + 17, CONFIG, TRAFFIC))
    b, wb = jobs.soups(_Ctx(2 ** 31 + 17, CONFIG, TRAFFIC))
    assert all(np.array_equal(x, y) for x, y in zip(a + [wa], b + [wb]))


def test_seeds_differ_with_the_same_sizes():
    a, _ = jobs.soups(_Ctx(1, CONFIG, TRAFFIC))
    b, _ = jobs.soups(_Ctx(2, CONFIG, TRAFFIC))
    assert not any(np.array_equal(x, y) for x, y in zip(a, b))

    def radii(soups):
        return [float(np.linalg.norm(x.reshape(-1, 3), axis=1).max())
                for x in soups]

    ra, rb = radii(a), radii(b)
    assert sorted(ra) == pytest.approx(sorted(rb), abs=1e-6)
    for k in range(0, len(a), 4):       # the same sizes in each block
        assert sorted(ra[k:k + 4]) == pytest.approx(sorted(rb[k:k + 4]),
                                                    abs=1e-6)


def test_fixed_scales_in_blocks():
    v1 = meshes.variants(3, 16, (0.97, 1.03), 0.0, block=8)
    v2 = meshes.variants(4, 16, (0.97, 1.03), 0.0, block=8)
    strata = [int((s - 0.97) / 0.06 * 16) for s, _, _ in v1[:-1]]
    assert sorted(strata) == list(range(16))
    for k in (0, 8):
        assert (sorted(s for s, _, _ in v1[k:k + 8])
                == sorted(s for s, _, _ in v2[k:k + 8]))
    assert [s for s, _, _ in v1[:-1]] != [s for s, _, _ in v2[:-1]]
    assert v1[-1][0] == 1.03 and all(a == 0.0 for _, _, a in v1)


def test_stl_round_trip_numbers_vertices_as_the_program():
    from levelsetfortran_tpu_torch import read_stl
    soup = meshes.transform(meshes.icosphere_soup(subdivisions=2), 1.01,
                            (1.0, 2.0, 3.0), 0.7)
    path = jobs.stl_files([soup], str(pytest.importorskip("tempfile")
                                      .mkdtemp()))[0]
    mesh = read_stl(path)
    verts, elems = geometry.soup_mesh(soup)
    assert np.array_equal(mesh.vertices, verts)
    assert np.array_equal(mesh.elements, elems)


def test_generators_match_the_programs():
    from levelsetfortran_tpu_torch.models import analytic
    for ours, theirs in (
            (meshes.icosphere_soup(subdivisions=3),
             analytic.icosphere_mesh(subdivisions=3)),
            (meshes.two_cubes_soup(), analytic.two_cubes_mesh()),
            (meshes.box_soup(subdiv=3), analytic.box_mesh(subdiv=3))):
        v, e = geometry.soup_mesh(ours)
        assert np.array_equal(v, theirs.vertices)
        assert np.array_equal(e, theirs.elements)


class _Jobs:
    def job(self, i):
        return {"wall": 0.0}, i


def _checked(monkeypatch, seed, n_jobs):
    """The job a window of ``n_jobs`` jobs keeps for its check, on a clock
    that moves one second a reading."""
    clock = iter(range(10 ** 6))
    monkeypatch.setattr(run.time, "perf_counter", lambda: next(clock))
    records, kept, _, failed = run.window(_Jobs(), n_jobs, seed)
    assert len(records) == n_jobs and failed == 0 and len(kept) == 1
    i, out = kept[0]
    assert out == i
    return i


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 5])
def test_checked_job_repeats_for_a_seed(monkeypatch, seed):
    assert _checked(monkeypatch, seed, 50) == _checked(monkeypatch, seed, 50)


def test_checked_job_spreads_over_the_window(monkeypatch):
    picks = [_checked(monkeypatch, seed, 50) for seed in range(60)]
    assert len(set(picks)) >= 20 and max(picks) >= 25
