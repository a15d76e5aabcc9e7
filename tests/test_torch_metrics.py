"""The port's in-loop metrics stream (``utils/metrics.py``) against the JAX
package's: the cases of ``tests/test_metrics.py``, each run through both
packages on the same float32 input.

Event iterations are held equal, RMS values within 1e-5 relative: the
port adds the squared changes in float64, the JAX package's jnp route in
float32, and the banded loops freeze 8^3 bricks where the JAX package
freezes its TPU tiles (measured at most 1.9e-6).  ``band_tiles`` counts the port's active bricks (a departure: the JAX
package counts its tiles), so it is held to the port's own brick mask, not
to the JAX number.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from levelsetfortran_tpu.parallel.mesh import make_mesh as jax_make_mesh
from levelsetfortran_tpu.parallel.sharded import \
    ShardedLevelSet as JaxSharded
from levelsetfortran_tpu.solvers.minmax_flow import (
    minmax_flow as jax_minmax_flow,
    minmax_flow_narrowband as jax_minmax_flow_narrowband)
from levelsetfortran_tpu.solvers.reinit import (
    reinit as jax_reinit, reinit_narrowband as jax_reinit_narrowband)
from levelsetfortran_tpu.utils import metrics as jmetrics
from levelsetfortran_tpu_torch.ops.weno_cuda import tile_activity
from levelsetfortran_tpu_torch.parallel.mesh import make_mesh
from levelsetfortran_tpu_torch.parallel.sharded import ShardedLevelSet
from levelsetfortran_tpu_torch.solvers import minmax_flow as mf
from levelsetfortran_tpu_torch.solvers import reinit as re
from levelsetfortran_tpu_torch.utils import metrics

torch.set_num_threads(1)


def _phi(shape=(12, 16, 20)):
    """``tests/test_metrics.py:_phi``: 2(|x| - 0.5) on [-1, 1]^3."""
    xs = [np.linspace(-1, 1, k) for k in shape]
    gx, gy, gz = np.meshgrid(*xs, indexing="ij")
    return (2.0 * (np.sqrt(gx ** 2 + gy ** 2 + gz ** 2) - 0.5)).astype(
        np.float32)


@pytest.fixture
def streams():
    """Fresh sinks in both packages, restored afterwards."""
    old = (metrics.get_stream(), jmetrics.get_stream())
    yield (metrics.set_stream(metrics.MetricsStream(log=False)),
           jmetrics.set_stream(jmetrics.MetricsStream(log=False)))
    metrics.set_stream(old[0])
    jmetrics.set_stream(old[1])


def _events(stream, stage):
    return sorted((e for e in stream.events if e["stage_name"] == stage),
                  key=lambda e: e["iteration"])


def _same_events(ours, ref, stage, rel=1e-5):
    a, b = _events(ours, stage), _events(ref, stage)
    assert [e["iteration"] for e in a] == [e["iteration"] for e in b]
    np.testing.assert_allclose([e["rms"] for e in a],
                               [e["rms"] for e in b], rtol=rel)
    return a


def test_reinit_emits_iteration_events(streams):
    ours, ref = streams
    phi = _phi()
    re.reinit(torch.tensor(phi), 0.05, 0.005, 8, 0.0, metrics_every=2)
    jax_reinit(jnp.asarray(phi), 0.05, 0.005, 8, 0.0, use_pallas=False,
               metrics_every=2).phi.block_until_ready()
    evs = _same_events(ours, ref, "reinit")
    assert [e["iteration"] for e in evs] == [2, 4, 6, 8]
    assert evs[-1]["rms"] < evs[0]["rms"]
    assert all(np.isfinite(e["rms"]) for e in evs)
    assert any("cells_per_s" in e for e in evs)
    assert all("band_tiles" not in e for e in evs)


def test_metrics_disabled_by_default(streams):
    ours, _ = streams
    phi = torch.tensor(_phi())
    re.reinit(phi, 0.05, 0.005, 4, 0.0)
    re.reinit_narrowband(phi, 0.05, 0.005, 4, 0.0, refresh_every=2)
    mf.minmax_flow(phi, 0.05, 1e-4, 4, 0.0)
    mf.minmax_flow_narrowband(phi, 0.05, 1e-4, 4, 0.0)
    assert not ours.events


def test_minmax_emits_events(streams):
    ours, ref = streams
    phi = _phi()
    mf.minmax_flow(torch.tensor(phi), 0.05, 0.05 ** 3, 4, 0.0,
                   metrics_every=1)
    jax_minmax_flow(jnp.asarray(phi), 0.05, 0.05 ** 3, 4, 0.0,
                    use_pallas=False,
                    metrics_every=1).phi.block_until_ready()
    evs = _same_events(ours, ref, "minmax")
    assert [e["iteration"] for e in evs] == [1, 2, 3, 4]


def test_narrowband_reinit_cadence_and_band_bricks(streams):
    """Chunks of 1 + 2 (refresh_every // 2) = 5 steps; every = 4 rounds to
    one chunk (JAX ``solvers/reinit.py:335-340``)."""
    ours, ref = streams
    phi = _phi((16, 24, 32))
    t = torch.tensor(phi)
    re.reinit_narrowband(t, 0.05, 0.005, 8, 0.0, refresh_every=4,
                         metrics_every=4)
    jax_reinit_narrowband(jnp.asarray(phi), 0.05, 0.005, 8, 0.0,
                          refresh_every=4, use_pallas=True,
                          metrics_every=4).phi.block_until_ready()
    evs = _same_events(ours, ref, "reinit_narrowband")
    assert [e["iteration"] for e in evs] == [5, 10]
    # the brick mask each chunk started from
    p5 = re.reinit_narrowband(t, 0.05, 0.005, 5, 0.0, refresh_every=4).phi
    margin = 5 * 0.005 / 0.05
    want = [int((tile_activity(p, 0.05, 8.1, margin) != 0).sum())
            for p in (t, p5)]
    assert [e["band_tiles"] for e in evs] == want
    assert want[0] >= 1


def test_narrowband_minmax_cadence_and_band_bricks(streams):
    """K = 4, refresh_every 8: chunks of 4 (1 + 2) = 12 steps; every = 30
    rounds down to two chunks, 24 (JAX ``solvers/minmax_flow.py:284-287``);
    the two-step tail emits nothing."""
    ours, ref = streams
    phi = _phi((16, 24, 32))
    t = torch.tensor(phi)
    r = mf.minmax_flow_narrowband(t, 0.05, 1e-4, 50, 0.0, refresh_every=8,
                                  metrics_every=30)
    jr = jax_minmax_flow_narrowband(jnp.asarray(phi), 0.05, 1e-4, 50, 0.0,
                                    refresh_every=8, use_pallas=True,
                                    metrics_every=30)
    assert r.iterations == int(jr.iterations) == 50
    evs = _same_events(ours, ref, "minmax_narrowband")
    assert [e["iteration"] for e in evs] == [24, 48]
    p12 = mf.minmax_flow_narrowband(t, 0.05, 1e-4, 12, 0.0,
                                    refresh_every=8).phi
    p36 = mf.minmax_flow_narrowband(p12, 0.05, 1e-4, 24, 0.0,
                                    refresh_every=8).phi
    want = [int(tile_activity(p, 0.05, 4.1, window="owned").sum())
            for p in (p12, p36)]
    assert [e["band_tiles"] for e in evs] == want


@pytest.mark.parametrize("narrow_band", [False, True])
def test_sharded_solver_emits_one_event_per_check(streams, eight_devices,
                                                  narrow_band):
    """(2,2,2) shards: one event per check for the whole mesh (the JAX
    package emits from shard (0,0,0) only); ``band_tiles`` of the banded
    min/max is every shard's active bricks."""
    ours, ref = streams
    n = (16, 16, 16)
    phi = _phi(n)
    dx = 2.0 / 15
    s = ShardedLevelSet(make_mesh((2, 2, 2), ["cpu"]), n, dx,
                        metrics_every=2, narrow_band=narrow_band)
    js = JaxSharded(jax_make_mesh((2, 2, 2), eight_devices), n, dx,
                    metrics_every=2, use_pallas=False)
    blocks = s.device_put(torch.tensor(phi))
    s.reinit(blocks, 0.1 * dx, 6, 0.0)
    s.minmax_flow(blocks, 0.01 * dx, 4, 0.0)
    jp = js.device_put(jnp.asarray(phi))
    js.reinit(jp, 0.1 * dx, 6, 0.0)[0].block_until_ready()
    js.minmax_flow(jp, 0.01 * dx, 4, 0.0)[0].block_until_ready()
    jax.effects_barrier()          # the JAX taps are asynchronous
    evs = _same_events(ours, ref, "reinit")
    assert [e["iteration"] for e in evs] == [2, 4, 6]
    mevs = _same_events(ours, ref, "minmax")
    assert [e["iteration"] for e in mevs] == [2, 4]
    if narrow_band:
        want = sum(int(tile_activity(b, dx, 4.1, window="owned").sum())
                   for b in blocks)
        assert [e["band_tiles"] for e in mevs] == [want, want]
    else:
        assert all("band_tiles" not in e for e in evs + mevs)
