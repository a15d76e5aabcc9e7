"""Three API gaps of the port closed against the JAX package: the culling
options (``build_init_culling(margin=, bucketed=)``, ``InitCulling.
cand_idx`` / ``max_k``), ``write_vti(ref_compat=True)`` and
``interior_mask(dtype=)``.

Tolerances: none for the tables, the bytes and the masks, held equal;
the init with a widened culling within 1e-5 of the init without (float32:
the extra candidates move the scan's tile boundaries, so a near-tie may
fall the other way).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from levelsetfortran_tpu.grid import grid as jgrid
from levelsetfortran_tpu.io import vti as jvti
from levelsetfortran_tpu.ops import init_sign as jinit
from levelsetfortran_tpu.ops import stencil as jstencil
from levelsetfortran_tpu_torch.grid import grid as tgrid
from levelsetfortran_tpu_torch.io import vti as tvti
from levelsetfortran_tpu_torch.models.analytic import (icosphere_mesh,
                                                       two_cubes_mesh)
from levelsetfortran_tpu_torch.ops import init_sign as tinit
from levelsetfortran_tpu_torch.ops import stencil as tstencil

MESHES = {"two_cubes": two_cubes_mesh,
          "icosphere2": lambda: icosphere_mesh(subdivisions=2)}
#: A spacing and margins at which the margin widens the candidate lists
#: (at dx 0.1 every 16^3 block of these meshes keeps the same lists).
DX = 0.05
MARGINS = {"two_cubes": 0.5, "icosphere2": 0.2}


def _cullings(mesh, **kw):
    m = MESHES[mesh]()
    grid = tgrid.from_surface(m.vertices, DX, 3)
    a = jinit.build_init_culling(
        jgrid.Grid3D(grid.shape, grid.origin, grid.dx), m.vertices,
        m.elements, tile=128, **kw)
    b = tinit.build_init_culling(grid, m.vertices, m.elements, tile=128,
                                 **kw)
    return a, b


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("kw", [{"margin": True}, {"bucketed": False},
                                {"margin": True, "bucketed": False}],
                         ids=["margin", "one_bucket", "both"])
def test_culling_options_match_jax(mesh, kw):
    kw = dict(kw, margin=MARGINS[mesh] if kw.get("margin") else 0.0)
    a, b = _cullings(mesh, **kw)
    assert (a.block, a.nblocks) == (b.block, b.nblocks)
    assert len(a.cands) == len(b.cands)
    for ca, cb, ia, ib in zip(a.cands, b.cands, a.bidxs, b.bidxs):
        np.testing.assert_array_equal(np.asarray(ca), cb)
        np.testing.assert_array_equal(np.asarray(ia), ib)
    assert a.max_k == b.max_k
    if kw.get("bucketed", True):
        for c in (a, b):
            if len(c.cands) > 1:
                with pytest.raises(ValueError, match="single-bucket"):
                    c.cand_idx
    else:
        np.testing.assert_array_equal(np.asarray(a.cand_idx), b.cand_idx)
        assert b.cand_idx.shape == (int(np.prod(b.nblocks)), b.max_k)
        assert b.max_k % 128 == 0


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_margin_only_adds_candidates(mesh):
    """A margin widens every block's bound: each block keeps at least the
    candidates it kept without one, and the init with either culling is
    the same field."""
    _, plain = _cullings(mesh)
    _, wide = _cullings(mesh, margin=MARGINS[mesh])

    def sets(c):
        out = {}
        for cand, ids in zip(c.cands, c.bidxs):
            for row, b in zip(cand, ids):
                out[int(b)] = set(row.tolist())
        return out

    p, w = sets(plain), sets(wide)
    assert p.keys() == w.keys() and all(p[k] <= w[k] for k in p)
    assert sum(map(len, w.values())) > sum(map(len, p.values()))
    m = MESHES[mesh]()
    grid = tgrid.from_surface(m.vertices, DX, 3)
    f_plain = tinit.signed_distance_init(grid, m.vertices, m.elements,
                                         culling=plain, tile=128)
    f_wide = tinit.signed_distance_init(grid, m.vertices, m.elements,
                                        culling=wide, tile=128)
    np.testing.assert_allclose(f_wide.numpy(), f_plain.numpy(), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("shape", [(7, 5, 4), (6, 6, 6)],
                         ids=["non_cubic", "cubic"])
def test_vti_ref_compat_bytes_match_jax(tmp_path, shape):
    grid = tgrid.Grid3D(shape, (0.5, -1.0, 0.25), 0.1)
    phi = np.random.default_rng(3).standard_normal(shape)
    tvti.write_vti(str(tmp_path / "p.vti"), phi, grid, name="phi",
                   ref_compat=True)
    jvti.write_vti(str(tmp_path / "j.vti"), phi,
                   jgrid.Grid3D(shape, grid.origin, grid.dx), name="phi",
                   ref_compat=True)
    data = (tmp_path / "p.vti").read_bytes()
    assert data == (tmp_path / "j.vti").read_bytes()
    start = data.index(b'<AppendedData encoding="raw">') + 31
    assert int.from_bytes(data[start:start + 4], "little") == \
        shape[0] ** 3 * 24
    tvti.write_vti(str(tmp_path / "q.vti"), phi, grid)
    assert (tmp_path / "q.vti").read_bytes() != data
    for reader in (jvti.read_vti, tvti.read_vti):
        back, g = reader(str(tmp_path / "p.vti"))
        np.testing.assert_array_equal(back, phi)
        assert tuple(g.shape) == shape


@pytest.mark.parametrize("depth", [0, 1, 4])
@pytest.mark.parametrize("dtypes", [(bool, torch.bool),
                                    (jnp.float32, torch.float32),
                                    (jnp.int32, torch.int32)],
                         ids=["bool", "float32", "int32"])
def test_interior_mask_dtype_matches_jax(depth, dtypes):
    jdt, tdt = dtypes
    shape = (12, 10, 9)
    ref = np.asarray(jstencil.interior_mask(shape, depth, dtype=jdt))
    out = tstencil.interior_mask(shape, depth, dtype=tdt, device="cpu")
    assert out.dtype == tdt and tuple(out.shape) == shape
    np.testing.assert_array_equal(out.numpy(), ref)
    assert tstencil.interior_mask(shape, depth).dtype == torch.bool
