"""The pack modes of kernels K1 and K3 (B same-shape geometries per launch,
each with its own h, its own fused sum and a frozen flag) and the batched
packed solvers, held against the JAX package's Pallas ``pack`` mode in
interpret mode and against the port's own solo steps.

Tolerances (float32; measured on a CPU with these inputs):
  * a packed step against the Pallas pack mode: live geometries within
    1e-6 for K1 (measured 6.0e-8: the two frameworks round the same
    expressions, H5) and 1e-7 for K3 (measured 3.0e-8); a frozen geometry
    is bitwise its input in both; the per-geometry sums rel 1e-5 (f32
    accumulation in the TPU kernel, f64 here; measured 1.8e-6);
  * the fixed-step packed scan: 1e-6 (measured 1.2e-7 after 4 steps);
  * the batched solvers against the JAX package's: equal per-geometry
    counts; fields within 1e-6 after up to 25 reinit steps (measured
    1.2e-7) and 5e-7 after 15 min/max steps (measured 8.9e-8); final RMS
    rel 1e-5 for reinit (measured 1.8e-6) and 2e-4 for min/max (measured
    6.4e-5: the TPU kernel sums the last step's ~1e-9 changes in f32);
  * a packed step against solo steps of the port: bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from levelsetfortran_tpu.ops import weno_pallas as wp
from levelsetfortran_tpu.ops.minmax_pallas import (_pick_tile as mm_tile,
                                                   minmax_step_padded)
from levelsetfortran_tpu.pipeline import batch as jax_batch
from levelsetfortran_tpu_torch.ops import minmax_cuda as mc
from levelsetfortran_tpu_torch.ops import weno_cuda as wc
from levelsetfortran_tpu_torch.pipeline import batch
from levelsetfortran_tpu_torch.solvers.minmax_flow import minmax_flow
from levelsetfortran_tpu_torch.solvers.reinit import reinit

torch.set_num_threads(1)
DX = 0.1


def _spheres(n, radii, scale):
    """(B, n, n, n) float32 sphere SDFs centred in the box, times scale."""
    xs = (np.arange(n) - (n - 1) / 2.0) * DX
    gx, gy, gz = np.meshgrid(xs, xs, xs, indexing="ij")
    r = np.sqrt(gx ** 2 + gy ** 2 + gz ** 2)
    return np.stack([scale * (r - rad) for rad in radii]).astype(np.float32)


def _jax_packed_active(b, gshape, tile, frozen):
    tpg = wp._ceil_to(gshape[0], tile[0]) // tile[0]
    nby = wp._ceil_to(gshape[1], tile[1]) // tile[1]
    act = np.ones((b * tpg, nby), np.int32)
    for g in frozen:
        act[g * tpg:(g + 1) * tpg] = 0
    return jnp.asarray(act)


def test_reinit_step_packed_matches_pallas_pack():
    """One packed K1 step with per-geometry h and geometry 1 frozen, on 16^3
    spheres (``tests/test_packed.py:63-91``)."""
    phis = _spheres(16, (0.45, 0.6, 0.7), 2.0)
    hv = np.asarray([0.08, 0.1, 0.12], np.float32) * np.float32(DX)
    gshape = phis.shape[1:]
    tile = wp._pick_tile(gshape)
    pk = wp.pack_for_pallas(jnp.asarray(phis), tile)
    out, dsq = wp._pallas_step_padded(
        pk, pk, jnp.float32(DX), jnp.asarray(hv), gshape=gshape,
        eps_scale=1e-6, eps_floor=1e-10, quirk_y_p5_zero=False, tile=tile,
        interpret=True, with_rms=True,
        active=_jax_packed_active(3, gshape, tile, [1]), pack=3)
    ref = np.asarray(wp.unpack_from_pallas(out, 3, gshape))
    ref_dsq = np.asarray(dsq)

    t = torch.from_numpy(phis)
    ours, ours_dsq = wc.reinit_step_packed(
        t, t, DX, hv, torch.tensor([1, 0, 1], dtype=torch.int32),
        with_rms=True, eps_floor=1e-10)
    assert ours.shape == t.shape and ours_dsq.dtype == torch.float64
    assert np.array_equal(ref[1], phis[1])
    assert torch.equal(ours[1], t[1]) and float(ours_dsq[1]) == 0.0
    for g in (0, 2):
        np.testing.assert_allclose(ours[g].numpy(), ref[g], rtol=0,
                                   atol=1e-6)
        assert float(ours_dsq[g]) == pytest.approx(float(ref_dsq[g]),
                                                   rel=1e-5)


def test_minmax_step_packed_matches_pallas_pack():
    """One packed K3 step, per-geometry h1, geometry 1 frozen, the band
    (4.1 dx) kept off the faces (H4: the kernels' face rules differ)."""
    phis = _spheres(20, (0.3, 0.35, 0.4), 1.0)
    phis[:, 8:12, 8:12, 8:12] += np.float32(0.5 * DX)   # a dent: work
    assert np.abs(phis[:, [0, -1]]).min() > 4.1 * DX
    hv = np.asarray([0.01, 0.02, 0.015], np.float32) * np.float32(DX)
    gshape = phis.shape[1:]
    tile = mm_tile(gshape)
    pk = wp.pack_for_pallas(jnp.asarray(phis), tile)
    out, dsq = minmax_step_padded(
        pk, jnp.float32(DX), jnp.asarray(hv), 4.1, 0.0, gshape=gshape,
        tile=tile, interpret=True, with_rms=True,
        active=_jax_packed_active(3, gshape, tile, [1]), pack=3)
    ref = np.asarray(wp.unpack_from_pallas(out, 3, gshape))
    ref_dsq = np.asarray(dsq)

    t = torch.from_numpy(phis)
    ours, ours_dsq = mc.minmax_step_packed(
        t, DX, hv, torch.tensor([1, 0, 1], dtype=torch.int32),
        with_rms=True)
    assert np.array_equal(ref[1], phis[1])
    assert torch.equal(ours[1], t[1]) and float(ours_dsq[1]) == 0.0
    for g in (0, 2):
        assert float(ours_dsq[g]) > 0.0
        np.testing.assert_allclose(ours[g].numpy(), ref[g], rtol=0,
                                   atol=1e-7)
        assert float(ours_dsq[g]) == pytest.approx(float(ref_dsq[g]),
                                                   rel=1e-5)


def test_reinit_scan_packed_matches_pallas_packed_scan():
    """The fixed-step serving scan (``reinit_scan_pallas_packed``), scalar
    and per-geometry h."""
    phis = _spheres(16, (0.45, 0.6, 0.7), 2.0)
    for h in (np.float32(0.1 * DX),
              np.asarray([0.08, 0.1, 0.12], np.float32) * np.float32(DX)):
        ref = np.asarray(wp.reinit_scan_pallas_packed(
            jnp.asarray(phis), DX, jnp.asarray(h), 4))
        ours = wc.reinit_scan_packed(torch.from_numpy(phis), DX, h, 4)
        np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-6)


def _batch_inputs():
    """``tests/test_packed.py:94-104``: three scaled spheres that keep
    integrating and an exact SDF that freezes almost at once."""
    phis = _spheres(20, (0.45, 0.6, 0.7), 2.0)
    exact = _spheres(20, (0.6,), 1.0)
    phis = np.concatenate([phis, exact])
    hv = np.asarray([0.08, 0.1, 0.12, 0.1], np.float32) * np.float32(DX)
    return phis, hv


def test_reinit_batched_packed_matches_jax():
    phis, hv = _batch_inputs()
    ref, ref_it, ref_rms, ref_div = jax_batch.reinit_batched_packed(
        jnp.asarray(phis), DX, jnp.asarray(hv), 25, 5e-4)
    ours = batch.reinit_batched_packed(torch.from_numpy(phis), DX, hv, 25,
                                       5e-4)
    iters = [int(c) for c in ref_it]
    assert ours.iterations.tolist() == iters
    assert iters[3] < iters[0]               # the exact SDF froze early
    np.testing.assert_allclose(ours.phi.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(ours.final_rms, np.asarray(ref_rms), rtol=1e-5)
    assert not ours.diverged.any() and not np.asarray(ref_div).any()


def test_minmax_batched_packed_matches_jax():
    phi = _spheres(20, (0.6,), 2.0)[0]
    phi[8:12, 8:12, 8:12] += np.float32(0.5 * DX)
    phis = np.stack([phi, np.float32(1.3) * phi])
    hv = np.asarray([0.01, 0.02], np.float32) * np.float32(DX)
    ref, ref_it, ref_rms, _ = jax_batch.minmax_batched_packed(
        jnp.asarray(phis), DX, jnp.asarray(hv), 15, 1e-9)
    ours = batch.minmax_batched_packed(torch.from_numpy(phis), DX, hv, 15,
                                       1e-9)
    assert ours.iterations.tolist() == [int(c) for c in ref_it]
    np.testing.assert_allclose(ours.phi.numpy(), np.asarray(ref), rtol=0,
                               atol=5e-7)
    np.testing.assert_allclose(ours.final_rms, np.asarray(ref_rms), rtol=2e-4)


def test_packed_steps_equal_solo_steps_bitwise():
    """Each live geometry of a packed step is a solo step with its h, the
    sums included; a frozen one is copied, its sum 0."""
    phis = torch.from_numpy(_spheres(12, (0.2, 0.3, 0.35, 0.4), 1.5))
    sign = torch.from_numpy(_spheres(12, (0.25, 0.3, 0.3, 0.45), 1.0))
    hv = np.asarray([0.05, 0.1, 0.07, 0.09], np.float32) * np.float32(DX)
    live = [1, 1, 0, 1]
    r, rd = wc.reinit_step_packed(phis, sign, DX, hv, live, with_rms=True)
    m, md = mc.minmax_step_packed(phis, DX, hv, live, with_rms=True)
    for g in range(4):
        if not live[g]:
            assert torch.equal(r[g], phis[g]) and torch.equal(m[g], phis[g])
            assert float(rd[g]) == 0.0 and float(md[g]) == 0.0
            continue
        s, sd = wc.reinit_step(phis[g], sign[g], DX, float(hv[g]),
                               with_rms=True)
        assert torch.equal(r[g], s) and float(rd[g]) == float(sd)
        s, sd = mc.minmax_step(phis[g], DX, float(hv[g]), with_rms=True)
        assert torch.equal(m[g], s) and float(md[g]) == float(sd)


def test_batched_packed_solvers_equal_solo_solvers():
    """Per-geometry counts and fields of the packed solvers equal the solo
    dense solvers' bitwise (the geometries stop at different steps)."""
    phis, hv = _batch_inputs()
    t = torch.from_numpy(phis)
    r = batch.reinit_batched_packed(t, DX, hv, 25, 5e-4)
    m = batch.minmax_batched_packed(r.phi, DX, hv * np.float32(0.1), 30,
                                    5e-4)
    assert len(set(r.iterations.tolist())) > 1
    assert len(set(m.iterations.tolist())) > 1
    for g in range(4):
        s = reinit(t[g], DX, float(hv[g]), 25, 5e-4)
        assert (s.iterations, s.final_rms) == (r.iterations[g],
                                               r.final_rms[g])
        assert torch.equal(r.phi[g], s.phi)
        s = minmax_flow(s.phi, DX, float(hv[g] * np.float32(0.1)), 30, 5e-4)
        assert (s.iterations, s.final_rms) == (m.iterations[g],
                                               m.final_rms[g])
        assert torch.equal(m.phi[g], s.phi)


@pytest.mark.parametrize("live", [[[1, 1]], [1, 1, 1]])
def test_live_must_be_one_flag_per_geometry(live):
    phis = torch.zeros((2, 5, 5, 5))
    assert wc.live_vector([1, 0], 2, "cpu").dtype == torch.int32
    with pytest.raises(ValueError):
        wc.reinit_step_packed(phis, phis, DX, 0.01, live)


def test_packed_vector_rounds_each_h_once():
    h = np.asarray([0.1, 1 / 3, 2.0 ** -30], np.float64)
    v = wc.packed_vector(h, 3, torch.float32, "cpu")
    assert v.dtype == torch.float32
    assert v.tolist() == [float(np.float32(x)) for x in h]
    assert wc.packed_vector(0.5, 4, torch.float32, "cpu").tolist() == [0.5] * 4
