"""K4's block mode (``minmax_cuda.minmax_fusedk_block``, the TPU kernel's
``minmax_fusedk_padded(offsets=...)``): K fused min/max steps of one
shard's padded block with a halo of K cells.  On the CPU the wrapper runs
its plain version, held here

* against the global plain K4 on (2,2,1) blocks, K = 1..4, dense and with
  a brick mask: the owned cells BITWISE, the per-block sums adding up to
  the global sum at 1e-12 relative (another order of the same float64
  terms);
* against the JAX package's ``minmax_fusedk_padded(offsets=(ox, oy),
  interpret=True)`` on one host-padded block of a 32x32x16 grid: 1e-7, the
  solo kernels' tolerance (other reciprocals, ROADMAP H5); the band stays
  off the global faces (H4);
* and its halo rule: a halo narrower than K raises.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from levelsetfortran_tpu.ops import minmax_pallas as mp
from levelsetfortran_tpu.ops import weno_pallas as wp
from levelsetfortran_tpu_torch.ops import minmax_cuda as mc
from levelsetfortran_tpu_torch.ops import weno_cuda as wc
from levelsetfortran_tpu_torch.parallel import sharded as sh
from levelsetfortran_tpu_torch.parallel.halo import crop, halo_exchange
from levelsetfortran_tpu_torch.parallel.mesh import (gather_blocks,
                                                     make_mesh, split_blocks)

torch.set_num_threads(1)
N = (32, 32, 16)
DX = 2.4 / 31
H1 = 0.05 * DX * DX          # stable: below dx^2 / 6


def sphere(n=N, scale=1.0, radius=0.6, noise=0.0):
    xs = [np.linspace(-1.2, 1.2, k) for k in n]
    gx, gy, gz = np.meshgrid(*xs, indexing="ij")
    p = scale * (np.sqrt(gx ** 2 + gy ** 2 + gz ** 2) - radius)
    if noise:
        p = p + noise * np.random.default_rng(3).standard_normal(n)
    return p.astype(np.float32)


def blocks_of(phi, m, k):
    w = sh.sharded_widths(m, k)
    return (w, halo_exchange(split_blocks(m, phi), w, m),
            sh.minmax_geoms(m, tuple(phi.shape), w))


@pytest.mark.parametrize("banded", [False, True])
@pytest.mark.parametrize("ksteps", [1, 2, 3, 4])
def test_owned_cells_bitwise_the_global_plain_k4(ksteps, banded):
    phi = torch.tensor(sphere(noise=0.002))
    m = make_mesh((2, 2, 1), ["cpu"])
    act = wc.tile_activity(phi, DX, 4.1, window="owned") if banded else None
    if banded:
        assert 0 < int(act.sum()) < act.numel()
    want, wsum = mc.minmax_fusedk_plain(phi, DX, H1, ksteps=ksteps,
                                        active=act, with_rms=True)
    assert not torch.equal(want, phi)
    w, pads, geoms = blocks_of(phi, m, ksteps)
    outs, total = [], 0.0
    for blk, pad, g in zip(split_blocks(m, phi), pads, geoms):
        a = wc.tile_activity(blk, DX, 4.1, window="owned") if banded \
            else None
        out, s = mc.minmax_fusedk_block(pad, DX, H1, g, ksteps=ksteps,
                                        active=a, with_rms=True)
        outs.append(crop(out, w).contiguous())
        total += float(s)
    assert torch.equal(gather_blocks(m, outs), want)
    assert abs(total - float(wsum)) <= 1e-12 * float(wsum)


def test_sum_counts_the_owned_box_of_the_last_step():
    """One block's sum is the last inner step's squared changes over its
    owned box (float64 terms of the global plain run): 1e-12 relative."""
    phi = torch.tensor(sphere(noise=0.002))
    m = make_mesh((2, 2, 1), ["cpu"])
    w, pads, geoms = blocks_of(phi, m, 3)
    prev = new = phi
    for _ in range(3):
        prev, new = new, mc.minmax_step_plain(new, DX, H1)
    d = (new - prev).double() ** 2
    for pad, g in zip(pads, geoms):
        _, s = mc.minmax_fusedk_block(pad, DX, H1, g, ksteps=3,
                                      with_rms=True)
        b = g.box()
        want = float(d[b[0]:b[1], b[2]:b[3], b[4]:b[5]].sum())
        assert want > 0 and abs(float(s) - want) <= 1e-12 * want


@pytest.mark.parametrize("ksteps", [2, 4])
def test_matches_jax_fusedk_padded_with_offsets(ksteps):
    """Shard (1, 0) of a (2,2,1) split, host-padded into the TPU kernel's
    layout (XA/YA aprons of neighbour cells, zeros past a global face, z
    padded to the lane width), against the port's block with a halo of K."""
    p0 = sphere()
    bx, by = N[0] // 2, N[1] // 2
    ox, oy = bx, 0
    nzp = wp.ZALIGN
    full = np.zeros((N[0] + 2 * wp.XA, N[1] + 2 * wp.YA, nzp), np.float32)
    full[wp.XA:wp.XA + N[0], wp.YA:wp.YA + N[1], :N[2]] = p0
    pad = full[ox:ox + bx + 2 * wp.XA, oy:oy + by + 2 * wp.YA]
    tile = mp._pick_tile((bx, by, nzp))
    ref = mp.minmax_fusedk_padded(
        jnp.asarray(pad), jnp.float32(DX), jnp.float32(H1),
        jnp.float32(4.1), jnp.float32(0.0), gshape=N, tile=tile,
        interpret=True, ksteps=ksteps, offsets=(ox, oy))
    ref = np.asarray(ref)[wp.XA:wp.XA + bx, wp.YA:wp.YA + by, :N[2]]

    phi = torch.tensor(p0)
    m = make_mesh((2, 2, 1), ["cpu"])
    w, pads, geoms = blocks_of(phi, m, ksteps)
    i = m.index((1, 0, 0))
    got = crop(mc.minmax_fusedk_block(pads[i], DX, H1, geoms[i],
                                      ksteps=ksteps), w).numpy()
    assert np.abs(got - p0[ox:ox + bx, oy:oy + by]).max() > 0
    assert np.abs(got - ref).max() <= 1e-7


def test_a_halo_narrower_than_k_raises():
    phi = torch.tensor(sphere())
    m = make_mesh((2, 2, 1), ["cpu"])
    _, pads, geoms = blocks_of(phi, m, 2)
    with pytest.raises(ValueError, match="halo"):
        mc.minmax_fusedk_block(pads[0], DX, H1, geoms[0], ksteps=3)
    with pytest.raises(ValueError, match="ksteps"):
        mc.minmax_fusedk_block(pads[0], DX, H1, geoms[0], ksteps=5)
