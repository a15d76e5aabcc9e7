"""The port's halo exchange between the blocks of a sharded field
(``levelsetfortran_tpu_torch/parallel/{mesh,halo}.py``) against slices of a
zero- or wrap-padded global array and against the JAX package's functions
under ``shard_map`` on virtual CPU devices.  Copies only: every comparison
is exact.  Its transpose, ``halo_exchange_transpose``, holds the
dot-product identity in float64 to 1e-12 relative (adds in another order)
and equals the JAX transpose exactly."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.sharding import PartitionSpec as P

from levelsetfortran_tpu.parallel import halo as jhalo
from levelsetfortran_tpu.parallel import mesh as jmesh
from levelsetfortran_tpu.parallel.sharded import shard_map
from levelsetfortran_tpu_torch.parallel import halo, mesh

torch.set_num_threads(1)
MESHES = [(2, 2, 1), (2, 2, 2), (1, 2, 4), (4, 2, 1)]
SHAPE = (16, 12, 16)


def _field(seed=0, shape=SHAPE):
    return np.random.default_rng(seed).standard_normal(shape)


def _padded_global(x, widths, periodic):
    spec = [v for w in reversed(widths) for v in (w, w)]
    t = torch.tensor(x)
    if periodic:
        return F.pad(t[None, None], spec, mode="circular")[0, 0]
    return F.pad(t, spec)


@pytest.mark.parametrize("width", [4, (3, 2, 1), (4, 0, 2)])
@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("mesh_shape", MESHES)
def test_halo_exchange_equals_slices_of_the_padded_global(mesh_shape,
                                                          periodic, width):
    """A halo holds the neighbour's cells inside the grid and, past a
    global face, zeros (or with ``periodic`` the other end's cells): every
    padded block is a window of the zero- or wrap-padded global array."""
    m = mesh.make_mesh(mesh_shape, ["cpu"])
    x = _field()
    widths = (width,) * 3 if isinstance(width, int) else width
    blocks = mesh.split_blocks(m, torch.tensor(x))
    pads = halo.halo_exchange(blocks, width, m, periodic=periodic)
    g = _padded_global(x, widths, periodic)
    b = m.block_shape(SHAPE)
    for off, p in zip(halo.local_offsets(m, b), pads):
        ref = g[tuple(slice(o, o + n + 2 * w)
                      for o, n, w in zip(off, b, widths))]
        assert torch.equal(p, ref)
        assert torch.equal(halo.crop(p, width),
                           torch.tensor(x)[tuple(slice(o, o + n) for o, n
                                                 in zip(off, b))])


def _jax_blocks(fn, x, mesh_shape, devices):
    """``fn`` under shard_map over a mesh of virtual CPU devices; the
    result is the blocks' outputs laid side by side."""
    jm = jmesh.make_mesh(mesh_shape, devices[:math.prod(mesh_shape)])
    spec = P(*jmesh.AXIS_NAMES)
    out = jax.jit(shard_map(fn, mesh=jm, in_specs=(spec,), out_specs=spec,
                            check_vma=False))(jnp.asarray(x))
    return np.asarray(jax.device_get(out))


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("mesh_shape", [(2, 2, 1), (2, 2, 2)])
def test_halo_exchange_equals_jax_under_shard_map(eight_devices, mesh_shape,
                                                  periodic):
    x = _field(1)
    width = (4, 3, 2)
    ref = _jax_blocks(lambda b: jhalo.halo_exchange(
        b, width, mesh_shape, periodic=periodic), x, mesh_shape,
        eight_devices)
    m = mesh.make_mesh(mesh_shape, ["cpu"])
    pads = halo.halo_exchange(mesh.split_blocks(m, torch.tensor(x)), width,
                              m, periodic=periodic)
    np.testing.assert_array_equal(mesh.gather_blocks(m, pads).numpy(), ref)


@pytest.mark.parametrize("mesh_shape", [(2, 2, 1), (2, 2, 2), (4, 2, 1)])
def test_refresh_halos_equals_exchange_and_jax(eight_devices, mesh_shape):
    """A persistently padded block whose halo holds garbage is refreshed
    in place to what a fresh exchange gives, and to the JAX refresh."""
    x = _field(2)
    widths = tuple(4 if n > 1 else 0 for n in mesh_shape)
    m = mesh.make_mesh(mesh_shape, ["cpu"])
    blocks = mesh.split_blocks(m, torch.tensor(x))
    spec = [v for w in reversed(widths) for v in (w, w)]
    pads = [F.pad(b, spec, value=float("nan")) for b in blocks]
    halo.refresh_halos(pads, widths, m)
    for a, b in zip(pads, halo.halo_exchange(blocks, widths, m)):
        assert torch.equal(a, b)

    def jax_refresh(b):
        pad = jnp.pad(b, [(w, w) for w in widths], constant_values=7.0)
        return jhalo.refresh_halos(pad, widths, mesh_shape)

    ref = _jax_blocks(jax_refresh, x, mesh_shape, eight_devices)
    np.testing.assert_array_equal(mesh.gather_blocks(m, pads).numpy(), ref)


@pytest.mark.parametrize("width", [(3, 2, 1), 2])
@pytest.mark.parametrize("mesh_shape", [(2, 2, 1), (2, 2, 2), (3, 1, 2)])
def test_halo_exchange_transpose_dot_product_identity(mesh_shape, width):
    """<halo_exchange(x), y> = <x, halo_exchange_transpose(y)> for random
    blocks x and padded blocks y, float64."""
    shape = (18, 12, 16)
    m = mesh.make_mesh(mesh_shape, ["cpu"])
    rng = np.random.default_rng(5)
    xs = mesh.split_blocks(m, torch.tensor(rng.standard_normal(shape)))
    pads = halo.halo_exchange(xs, width, m)
    ys = [torch.tensor(rng.standard_normal(p.shape)) for p in pads]
    back = halo.halo_exchange_transpose(ys, width, m)
    assert [b.shape for b in back] == [x.shape for x in xs]
    lhs = sum(float(torch.sum(p * y)) for p, y in zip(pads, ys))
    rhs = sum(float(torch.sum(x * b)) for x, b in zip(xs, back))
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)


@pytest.mark.parametrize("mesh_shape", [(2, 2, 1), (2, 2, 2)])
def test_halo_exchange_transpose_equals_jax_under_shard_map(eight_devices,
                                                            mesh_shape):
    """Padded cotangent blocks laid side by side, folded back by the JAX
    transpose under shard_map and by the port's."""
    width = (3, 2, 1)
    b = tuple(n // k for n, k in zip(SHAPE, mesh_shape))
    padded = tuple(k * (n + 2 * w) for k, n, w in zip(mesh_shape, b, width))
    y = np.random.default_rng(6).standard_normal(padded)
    ref = _jax_blocks(lambda c: jhalo.halo_exchange_transpose(
        c, width, mesh_shape), y, mesh_shape, eight_devices)
    m = mesh.make_mesh(mesh_shape, ["cpu"])
    back = halo.halo_exchange_transpose(
        mesh.split_blocks(m, torch.tensor(y)), width, m)
    np.testing.assert_array_equal(mesh.gather_blocks(m, back).numpy(), ref)


def test_halo_exchange_carries_a_channel_axis():
    m = mesh.make_mesh((2, 1, 2), ["cpu"])
    x = torch.tensor(_field(3, SHAPE + (3,)))
    pads = halo.halo_exchange(mesh.split_blocks(m, x), 1, m)
    assert pads[0].shape == (10, 14, 10, 3)
    assert torch.equal(pads[0][1:-1, 1:-1, -1], x[:8, :, 8])


@pytest.mark.parametrize("n", range(1, 17))
def test_factor3_equals_jax(n):
    assert mesh.factor3(n) == jmesh.factor3(n)
    assert mesh.factor3(n, prefer_z1=True) == jmesh.factor3(n,
                                                            prefer_z1=True)


def test_mesh_layout_round_robin_and_errors():
    assert mesh.pad_to_multiple((17, 9, 5), (2, 2, 2)) == \
        jmesh.pad_to_multiple((17, 9, 5), (2, 2, 2)) == (18, 10, 6)
    m = mesh.make_mesh((2, 2, 1), ["cpu"])
    assert m.n_shards == 4 and set(m.devices) == {torch.device("cpu")}
    assert [m.index(c) for c in m.coords()] == [0, 1, 2, 3]
    assert m.coords()[1] == (0, 1, 0)          # z fastest, then y
    assert mesh.make_mesh(None, ["cpu"]).shape == (1, 1, 1)
    x = torch.tensor(_field(4))
    assert torch.equal(mesh.gather_blocks(m, mesh.split_blocks(m, x)), x)
    assert halo.local_offsets(m, (8, 6, 16)) == [(0, 0, 0), (0, 6, 0),
                                                 (8, 0, 0), (8, 6, 0)]
    with pytest.raises(ValueError):
        m.block_shape((17, 12, 16))
    with pytest.raises(ValueError):
        mesh.make_mesh((2, 0, 1), ["cpu"])
    assert mesh.default_devices("cpu") == [torch.device("cpu")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            mesh.default_devices("cuda")
