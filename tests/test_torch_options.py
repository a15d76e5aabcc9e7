"""The solvers' non-default options and the public helpers of the port
against the JAX package, float64 on the CPU (inputs made with numpy from a
seed):

* ``mean_curvature``, ``minmax_rhs(use_true_curvature=True)``,
  ``laplacian``, ``hard_sign`` and ``gradient_magnitude`` (orders 2 and 8):
  1e-12;
* ``minmax_flow`` with ``use_true_curvature`` and ``avg_halfwidth=2`` at
  24^3: the same iterations, the fields at 1e-12;
* ``minmax_flow_fixed`` with each option and ``reinit`` / ``reinit_fixed``
  with ``grad_fn = gradient_magnitude(., dx)``: values and the gradients in
  phi0, dx and h1 (h) at rtol 1e-10 (the same float64 expressions, summed
  in another order);
* the resumable solvers pass each option through (bitwise the unchunked
  solve);
* the route depends on the options alone: the default options reach the
  kernel wrappers (on a CPU tensor they run the plain versions), the
  others never do.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from levelsetfortran_tpu.ops import derivs as jderivs
from levelsetfortran_tpu.ops import minmax as jminmax
from levelsetfortran_tpu.ops import sign as jsign
from levelsetfortran_tpu.pipeline.run import \
    gradient_magnitude as jax_gradient_magnitude
from levelsetfortran_tpu.solvers.minmax_flow import \
    minmax_flow as jax_minmax_flow
from levelsetfortran_tpu.solvers.minmax_flow import \
    minmax_flow_fixed as jax_minmax_flow_fixed
from levelsetfortran_tpu.solvers.reinit import reinit as jax_reinit
from levelsetfortran_tpu.solvers.reinit import \
    reinit_fixed as jax_reinit_fixed
from levelsetfortran_tpu_torch.ops import derivs, minmax, minmax_cuda, sign
from levelsetfortran_tpu_torch.ops import weno_cuda
from levelsetfortran_tpu_torch.pipeline.run import gradient_magnitude
from levelsetfortran_tpu_torch.solvers import checkpointed
from levelsetfortran_tpu_torch.solvers import minmax_flow as mf
from levelsetfortran_tpu_torch.solvers import reinit as re

torch.set_num_threads(1)
N = 24
DX = 2.4 / (N - 1)
H1 = 0.05 * DX * DX
H = 0.1 * DX


def field(n=N, seed=0, noise=0.02):
    """A sphere of radius 0.6 pulled into a box along x, with noise."""
    xs = np.linspace(-1.2, 1.2, n)
    gx, gy, gz = np.meshgrid(xs, xs, xs, indexing="ij")
    p = np.sqrt((0.8 * gx) ** 2 + gy ** 2 + gz ** 2) - 0.6
    rng = np.random.default_rng(seed)
    return p + noise * DX * rng.standard_normal(p.shape)


def close(a, b, tol=1e-12):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() <= tol * max(1.0, np.abs(b).max())


def test_pointwise_helpers_match_jax():
    p = field()
    t, j = torch.tensor(p), jnp.asarray(p)
    assert close(minmax.mean_curvature(t, DX), jminmax.mean_curvature(j, DX))
    assert close(derivs.laplacian(t, DX), jderivs.laplacian(j, DX))
    assert close(sign.hard_sign(t), jsign.hard_sign(j), 0.0)
    got = minmax.minmax_rhs(t, DX, use_true_curvature=True, threshold=0.01)
    want = jminmax.minmax_rhs(j, DX, use_true_curvature=True, threshold=0.01)
    assert close(got, want)
    assert not close(got, minmax.minmax_rhs(t, DX, threshold=0.01), 1e-3)
    for order in (2, 8):
        assert close(gradient_magnitude(t, DX, order),
                     jax_gradient_magnitude(j, DX, order))
    assert close(gradient_magnitude(p, DX), jax_gradient_magnitude(p, DX))


@pytest.mark.parametrize("opts", [dict(use_true_curvature=True),
                                  dict(avg_halfwidth=2,
                                       use_true_curvature=True)])
def test_minmax_flow_options_match_jax(opts):
    p = field()
    got = mf.minmax_flow(torch.tensor(p), DX, H1, 60, 1e-6, **opts)
    want = jax_minmax_flow(jnp.asarray(p), DX, H1, 60, 1e-6, **opts)
    assert got.iterations == int(want.iterations) and 1 < got.iterations
    assert close(got.phi, want.phi)
    assert abs(got.final_rms - float(want.final_rms)) <= \
        1e-10 * float(want.final_rms)


def _grads_torch(fn, p, *scalars, seed=7):
    w = torch.tensor(np.random.default_rng(seed).standard_normal(p.shape))
    leaves = [torch.tensor(p, requires_grad=True)] + [
        torch.tensor(s, dtype=torch.float64, requires_grad=True)
        for s in scalars]
    out = fn(*leaves)
    (out * w).sum().backward()
    return out.detach().numpy(), [x.grad.numpy() for x in leaves]


def _grads_jax(fn, p, *scalars, seed=7):
    w = jnp.asarray(np.random.default_rng(seed).standard_normal(p.shape))
    args = [jnp.asarray(p)] + [jnp.asarray(s, jnp.float64) for s in scalars]
    out = fn(*args)
    grads = jax.grad(lambda *a: jnp.sum(fn(*a) * w),
                     argnums=tuple(range(len(args))))(*args)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _rel(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.mark.parametrize("opts", [dict(use_true_curvature=True),
                                  dict(avg_halfwidth=2)])
def test_minmax_flow_fixed_options_values_and_gradients(opts):
    p = field(seed=1)
    steps = 6
    got, gg = _grads_torch(lambda q, dx, h1: mf.minmax_flow_fixed(
        q, dx, h1, steps, **opts), p, DX, H1)
    want, gw = _grads_jax(lambda q, dx, h1: jax_minmax_flow_fixed(
        q, dx, h1, steps, **opts), p, DX, H1)
    assert _rel(got, want) <= 1e-10
    for a, b in zip(gg, gw):
        assert np.abs(b).max() > 0 and _rel(a, b) <= 1e-10


def _grad_fn_torch(q):
    return gradient_magnitude(q, DX)


def _grad_fn_jax(q):
    return jax_gradient_magnitude(q, DX)


def test_reinit_with_grad_fn_matches_jax():
    p = 1.7 * field(seed=2)
    got = re.reinit(torch.tensor(p), DX, H, 40, 1e-5,
                    grad_fn=_grad_fn_torch)
    want = jax_reinit(jnp.asarray(p), DX, H, 40, 1e-5, grad_fn=_grad_fn_jax)
    assert got.iterations == int(want.iterations) and got.iterations > 2
    assert close(got.phi, want.phi)
    dflt = re.reinit(torch.tensor(p), DX, H, 40, 1e-5)
    assert not close(got.phi, dflt.phi, 1e-4)


def test_reinit_fixed_with_grad_fn_values_and_gradients():
    p = 1.7 * field(seed=3)
    steps = 5
    got, gg = _grads_torch(lambda q, dx, h: re.reinit_fixed(
        q, dx, h, steps, grad_fn=_grad_fn_torch), p, DX, H)
    want, gw = _grads_jax(lambda q, dx, h: jax_reinit_fixed(
        q, dx, h, steps, grad_fn=_grad_fn_jax), p, DX, H)
    assert _rel(got, want) <= 1e-10
    for a, b in zip(gg, gw):
        assert np.abs(b).max() > 0 and _rel(a, b) <= 1e-10


@pytest.mark.parametrize("stage,opts", [
    ("reinit", dict(grad_fn=_grad_fn_torch)),
    ("minmax", dict(avg_halfwidth=2)),
    ("minmax", dict(use_true_curvature=True))])
def test_resumable_solvers_pass_the_options_through(stage, opts):
    p = torch.tensor(field(seed=4))
    if stage == "reinit":
        r = checkpointed.reinit_resumable(p, DX, H, 12, 0.0, chunk=5, **opts)
        one = re.reinit(p, DX, H, 12, 0.0, **opts)
        dflt = re.reinit(p, DX, H, 12, 0.0)
    else:
        r = checkpointed.minmax_resumable(p, DX, H1, 12, 0.0, chunk=5,
                                          **opts)
        one = mf.minmax_flow(p, DX, H1, 12, 0.0, **opts)
        dflt = mf.minmax_flow(p, DX, H1, 12, 0.0)
    assert r.iterations == 12 and torch.equal(r.phi, one.phi)
    assert not torch.equal(r.phi, dflt.phi)


class _Calls:
    """Wrap the kernel wrappers the dense solvers launch, counting calls."""

    NAMES = ((minmax_cuda, "minmax_step"), (minmax_cuda, "minmax_step_vjp"),
             (weno_cuda, "reinit_step"), (weno_cuda, "reinit_step_vjp"))

    def __init__(self, monkeypatch):
        self.n = {name: 0 for _, name in self.NAMES}
        for mod, name in self.NAMES:
            real = getattr(mod, name)

            def wrapped(*a, _real=real, _name=name, **kw):
                self.n[_name] += 1
                return _real(*a, **kw)
            monkeypatch.setattr(mod, name, wrapped)


def _solve_all(p, dx, h, h1, **opts):
    """Each dense solver once, forward and backward, with ``opts``."""
    ropts = {k: v for k, v in opts.items() if k == "grad_fn"}
    mopts = {k: v for k, v in opts.items() if k != "grad_fn"}
    re.reinit(p, dx, h, 3, 0.0, **ropts)
    mf.minmax_flow(p, dx, h1, 3, 0.0, **mopts)
    q = p.clone().requires_grad_(True)
    (re.reinit_fixed(q, dx, h, 2, **ropts).sum()
     + mf.minmax_flow_fixed(q, dx, h1, 2, **mopts).sum()).backward()


def test_default_options_reach_the_kernel_wrappers(monkeypatch):
    calls = _Calls(monkeypatch)
    _solve_all(torch.tensor(field(n=16), dtype=torch.float32), DX, H, H1)
    # 3 solve steps, 2 fixed steps (the backward reads the stashed ones)
    assert calls.n == {"minmax_step": 3 + 2, "minmax_step_vjp": 2,
                       "reinit_step": 3 + 2, "reinit_step_vjp": 2}


@pytest.mark.parametrize("opts", [
    dict(grad_fn=_grad_fn_torch, avg_halfwidth=2),
    dict(grad_fn=_grad_fn_torch, use_true_curvature=True)])
def test_other_options_launch_no_kernel(monkeypatch, opts):
    calls = _Calls(monkeypatch)
    _solve_all(torch.tensor(field(n=16), dtype=torch.float32), DX, H, H1,
               **opts)
    assert set(calls.n.values()) == {0}
