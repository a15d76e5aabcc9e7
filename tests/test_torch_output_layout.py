"""The pipeline hands the host its grid fields x fastest in memory, the
``.vti`` payload's order, made on the device: the same values as a
C-ordered hand-over, and ``write_vti`` writes them from their own memory
with the same bytes as for any other layout and as the JAX package's
writer."""

import numpy as np
import pytest
import torch

from levelsetfortran_tpu.grid import grid as jgrid
from levelsetfortran_tpu.io import vti as jvti
from levelsetfortran_tpu_torch.config import LevelSetConfig
from levelsetfortran_tpu_torch.io import vti as tvti
from levelsetfortran_tpu_torch.models import analytic
from levelsetfortran_tpu_torch.pipeline import batch, run
from levelsetfortran_tpu_torch.utils import profiling

torch.set_num_threads(1)

CONFIG = dict(dx=0.12, pad_cells=6, reinit_iters=12, minmax_iters=6,
              final_reinit_iters=4, advect_iters=3, device="cpu")
ENTRIES = ("run_mesh", "run_mesh_sharded", "run_batch")


def _fields(entry: str) -> list:
    """(field, grid) of every grid field an entry point hands over."""
    mesh = analytic.icosphere_mesh(radius=0.5, subdivisions=1)
    if entry == "run_batch":
        box = analytic.box_mesh(half_extent=(0.5, 0.4, 0.3))
        items = batch.run_batch([mesh, box], LevelSetConfig(**CONFIG),
                                strategy="packed")
        return [(f, it.grid) for it in items
                for f in (it.phi_init, it.phi_smoothed)]
    cfg = LevelSetConfig(**CONFIG, **(
        dict(mesh_shape=(2, 2, 1), gather_results=True)
        if entry == "run_mesh_sharded" else {}))
    res = run.run_mesh(mesh, cfg)
    return [(f, res.grid)
            for f in (res.phi_init, res.phi_smoothed, res.phi_final)]


@pytest.fixture(scope="module", params=ENTRIES)
def handed(request):
    """An entry point's fields as handed over, and as a C-ordered
    hand-over (``_host``) gives them from the same run."""
    now = _fields(request.param)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(run, "_host_field", run._host)
        mp.setattr(batch, "_host_field", run._host)
        c_order = _fields(request.param)
    return now, c_order


def _bits(a: np.ndarray) -> bytes:
    """The values in logical (C) order, as raw bytes: equal bits, NaNs
    and signed zeros included."""
    return a.tobytes(order="C")


def test_fields_x_fastest_and_bitwise_a_c_ordered_hand_over(handed):
    now, c_order = handed
    assert len(now) == len(c_order) > 0
    for (f, grid), (c, _) in zip(now, c_order):
        assert f.dtype == np.float64 and f.shape == grid.shape
        assert f.transpose(2, 1, 0).flags.c_contiguous
        assert c.flags.c_contiguous
        assert _bits(f) == _bits(np.ascontiguousarray(f)) == _bits(c)


@pytest.mark.parametrize("ref_compat", [False, True])
def test_vti_bytes_of_every_layout_equal_the_jax_writer(handed, ref_compat,
                                                        tmp_path):
    now, _ = handed
    f, grid = now[0]
    c = np.ascontiguousarray(f)
    tvti.write_vti(str(tmp_path / "x.vti"), f, grid, ref_compat=ref_compat)
    tvti.write_vti(str(tmp_path / "c.vti"), c, grid, ref_compat=ref_compat)
    jvti.write_vti(str(tmp_path / "j.vti"), c,
                   jgrid.Grid3D(grid.shape, grid.origin, grid.dx),
                   ref_compat=ref_compat)
    want = (tmp_path / "j.vti").read_bytes()
    assert (tmp_path / "x.vti").read_bytes() == want
    assert (tmp_path / "c.vti").read_bytes() == want
    back, _ = tvti.read_vti(str(tmp_path / "x.vti"))
    assert _bits(back) == _bits(f)


def test_writes_and_host_transposes_counted(handed, tmp_path):
    """A result's two fields go out with no host transpose; a C-ordered
    array takes one.  Both are counted, the zero too."""
    now, _ = handed
    (a, grid), (b, _) = now[:2]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        profiling._counters.clear()
        tvti.write_vti(str(tmp_path / "a.vti"), a, grid)
        tvti.write_vti(str(tmp_path / "b.vti"), b, grid)
        two = profiling.counters()
        tvti.write_vti(str(tmp_path / "c.vti"), np.ascontiguousarray(a),
                       grid)
        three = profiling.counters()
    profiling._counters.clear()
    assert two == {"vti.writes": 2, "vti.host_transposes": 0}
    assert three == {"vti.writes": 3, "vti.host_transposes": 1}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
@pytest.mark.parametrize("shape", [(7, 5, 3), (1, 5, 3), (7, 1, 1)])
def test_host_field_is_host_transposed(dtype, shape):
    """``_host_field`` gives ``_host``'s values, x fastest in memory, for
    every dtype and for axes of one point."""
    t = torch.randn(shape, dtype=torch.float64).to(dtype)
    got = run._host_field(t)
    want = run._host(t)
    assert got.shape == want.shape == shape and got.dtype == np.float64
    assert got.transpose(2, 1, 0).flags.c_contiguous
    assert _bits(got) == _bits(want)
