"""The differentiable fixed-step reinit ``reinit_fixed`` (K1 forward, K5
backward per step) against the JAX package's ``reinit_fixed``, and the
flat / sqrt-N reverse sweeps of ``ops/reverse.py``.

Tolerances: the JAX package's own gates for its fused scan against the jnp
scan — phi0 atol 2e-4, rtol 1e-3; dx and h rtol 2e-3
(``tests/test_pallas.py:72-164``).  sqrt-N against flat: bitwise (the
recomputed trajectory and every adjoint step are deterministic).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from levelsetfortran_tpu.ops import weno_pallas as wp
from levelsetfortran_tpu.solvers.reinit import reinit_fixed as jax_fixed
from levelsetfortran_tpu_torch.ops import reverse
from levelsetfortran_tpu_torch.ops import weno_cuda as wc
from levelsetfortran_tpu_torch.solvers.reinit import reinit_fixed

torch.set_num_threads(1)
DX, H = 0.05, 0.005


def _field(shape, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    xs = [np.linspace(-1, 1, k) for k in shape]
    gx, gy, gz = np.meshgrid(*xs, indexing="ij")
    phi = np.sqrt(gx ** 2 + gy ** 2 + gz ** 2) - 0.5
    return (2.0 * phi + 0.01 * rng.standard_normal(shape)).astype(dtype)


def test_reinit_fixed_matches_jax_scan_gradient():
    """Gradients of a weighted sum of 3 fixed steps w.r.t. phi0, dx and h
    against the JAX package's ``reinit_fixed(use_pallas=False)``."""
    shape = (12, 14, 16)
    phi = _field(shape, 4)
    w = np.random.default_rng(5).standard_normal(shape).astype(np.float32)

    def jloss(p, d, hh):
        return jnp.sum(jnp.asarray(w) * jax_fixed(p, d, hh, 3,
                                                  use_pallas=False))

    gp, gd, gh = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(phi), jnp.float32(DX), jnp.float32(H))
    p = torch.from_numpy(phi).requires_grad_(True)
    d = torch.tensor(DX, dtype=torch.float32, requires_grad=True)
    hh = torch.tensor(H, dtype=torch.float32, requires_grad=True)
    out = reinit_fixed(p, d, hh, 3)
    (torch.from_numpy(w) * out).sum().backward()
    assert reverse.last_branch["reinit_fixed"] == "flat"
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(gp), atol=2e-4,
                               rtol=1e-3)
    np.testing.assert_allclose(float(d.grad), float(gd), rtol=2e-3)
    np.testing.assert_allclose(float(hh.grad), float(gh), rtol=2e-3)
    assert d.grad.dtype == torch.float32 and d.grad.shape == ()
    # the forward is the solver's K1 steps; phi0 is never written into
    q = torch.from_numpy(phi)
    for _ in range(3):
        q = wc.reinit_step(q, torch.from_numpy(phi), DX, H)
    assert torch.equal(out.detach(), q)
    assert torch.equal(p.detach(), torch.from_numpy(_field(shape, 4)))


def test_sqrtn_equals_flat(monkeypatch):
    """The two-level (sqrt-N) sweep gives the flat stash's gradient bit for
    bit (segments [3, 2] exercise the remainder segment)."""
    shape = (12, 10, 9)
    phi = _field(shape, 7)
    w = torch.from_numpy(
        np.random.default_rng(1).standard_normal(shape).astype(np.float32))

    def grads():
        p = torch.from_numpy(phi).requires_grad_(True)
        d = torch.tensor(DX, dtype=torch.float32, requires_grad=True)
        (w * reinit_fixed(p, d, H, 5)).sum().backward()
        return p.grad, d.grad

    g_flat = grads()
    assert reverse.last_branch["reinit_fixed"] == "flat"
    monkeypatch.setattr(reverse, "_FLAT_TRAJ_BYTES", 0)
    g_sqrt = grads()
    assert reverse.last_branch["reinit_fixed"] == "sqrtn"
    assert reverse._segments(5) == [3, 2]
    assert torch.equal(g_flat[0], g_sqrt[0])
    assert torch.equal(g_flat[1], g_sqrt[1])


@pytest.mark.parametrize("steps", [1, 2, 5, 9, 10, 50, 200])
def test_segments_match_jax(steps):
    assert reverse._segments(steps) == wp._segments(steps)
    assert sum(reverse._segments(steps)) == steps
    assert reverse._FLAT_TRAJ_BYTES == wp._FLAT_TRAJ_BYTES


@pytest.mark.parametrize("steps", [0, 1, 4, 7])
def test_checkpointed_reverse_visits_every_input_in_reverse(monkeypatch,
                                                            steps):
    """Both branches feed bstep the forward inputs p_0 .. p_{n-1}, last
    first, whatever the segment split."""
    for budget in (10 ** 9, 0):
        monkeypatch.setattr(reverse, "_FLAT_TRAJ_BYTES", budget)
        seen = reverse.checkpointed_reverse(
            lambda p: p + 1, lambda c, p: c + [p], 0, [], steps, 1)
        assert seen == list(range(steps))[::-1]
