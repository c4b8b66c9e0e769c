"""The port's reference contact solver vs the JAX package's, in f64.

cone_solve, solve_contacts and _mf_pure run the same algorithm as JAX's
(grid + parabola + guarded Newton); the port writes dE/dtheta and
d2E/dtheta2 out analytically where JAX takes jax.grad twice. Tolerance 1e-9
relative to the impulse scale: both are f64 and differ by summation order
only, so the agreement is ~1e-14 unless a Newton acceptance test or an argmin
sits exactly on a tie."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import one_thread  # noqa: F401  (a module fixture)

TOL = 1e-9


def _spd(rng, B, n):
  A = rng.standard_normal((B, n, n))
  return A @ A.transpose(0, 2, 1) + 0.5 * np.eye(n)


def _factor_problem(rng, B, nc, nv=None):
  """Random factors (Jr, Wt = Jr M^-1, vf, bias, mu, active), f64 numpy.
  nv >= 3 nc keeps G full-rank, so the solution is unique."""
  nv = 3 * nc + 4 if nv is None else nv
  Jr = rng.standard_normal((B, nc, 3, nv))
  M = _spd(rng, B, nv) + 3.0 * np.eye(nv)
  Wt = np.einsum("bicv,bvw->bicw", Jr, np.linalg.inv(M))
  vf = rng.standard_normal((B, nv))
  bias = 0.1 * np.abs(rng.standard_normal((B, nc, 3))) * np.array([0.0, 0.0, 1.0])
  mu = rng.uniform(0.3, 1.2, (B, nc))
  active = (rng.uniform(size=(B, nc)) > 0.3).astype(np.float64)
  return Jr, Wt, vf, bias, mu, active


def _t(*xs):
  return [torch.tensor(x) for x in xs]


def test_cone_solve_matches_jax():
  from raisimlib_tpu.ops import contact as jct
  from raisimlib_torch.ops import contact as tct

  rng = np.random.default_rng(0)
  B = 96
  G = _spd(rng, B, 3)
  c = rng.standard_normal((B, 3))
  c[: B // 2, 2] = -np.abs(c[: B // 2, 2])          # half approaching: stick/slip
  mu = rng.uniform(0.1, 1.5, B)
  mu[-4:] = 1e7                                     # bilateral sentinel
  lj = np.asarray(jax.jit(jax.vmap(lambda g, cc, m: jct.cone_solve(g, cc, m)))(G, c, mu))
  lt = tct.cone_solve(*_t(G, c, mu)).numpy()
  scale = np.abs(lj).max() + 1.0
  assert np.abs(lt - lj).max() / scale < TOL
  # the batch covers every case: open, stick and slip
  open_ = np.all(lj == 0.0, axis=1)
  assert open_.any() and (~open_).any()


@pytest.mark.parametrize("nc", [1, 4])
def test_solve_contacts_and_mf_pure_match_jax(nc):
  from raisimlib_tpu.ops import contact as jct
  from raisimlib_tpu.ops import pallas_contact as jpc
  from raisimlib_torch.ops import contact as tct
  from raisimlib_torch.ops import gpu_contact as tgc

  rng = np.random.default_rng(nc)
  B = 8
  args = _factor_problem(rng, B, nc)
  uj, lj = jax.jit(lambda *a: jpc._mf_pure(*a, jct.SolverConfig()))(*args)
  ut, lt = tgc._mf_pure(*_t(*args))
  scale = float(np.abs(np.asarray(lj)).max()) + 1.0
  assert np.abs(lt.numpy() - np.asarray(lj)).max() / scale < TOL
  assert np.abs(ut.numpy() - np.asarray(uj)).max() / scale < TOL

  # solve_contacts on the Delassus form, with a warm start
  Jr, Wt, vf, bias, mu, active = args
  Jf, Wf = Jr.reshape(B, 3 * nc, -1), Wt.reshape(B, 3 * nc, -1)
  G = np.einsum("brv,bsv->brs", Jf, Wf).reshape(B, nc, 3, nc, 3)
  c0 = np.einsum("brv,bv->br", Jf, vf).reshape(B, nc, 3) - bias
  lam0 = 0.1 * rng.standard_normal((B, nc, 3))
  cfg = jct.SolverConfig(sweeps=4)
  lj2 = jax.jit(jax.vmap(lambda g, c, m, a, l: jct.solve_contacts(
      g, c, m, a, l, config=cfg)))(G, c0, mu, active, lam0)
  lt2 = tct.solve_contacts(*_t(G, c0, mu, active, lam0),
                           config=tct.SolverConfig(sweeps=4))
  assert np.abs(lt2.numpy() - np.asarray(lj2)).max() / scale < TOL


def test_backward_matches_jax_grad_through_mf_pure():
  """solve_dynamics_batch's backward (autograd through _mf_pure) equals
  jax.grad through the JAX _mf_pure, which is what JAX's custom VJP runs."""
  from raisimlib_tpu.ops import contact as jct
  from raisimlib_tpu.ops import pallas_contact as jpc
  from raisimlib_torch.ops import gpu_contact as tgc

  rng = np.random.default_rng(11)
  B, nc, nv = 3, 4, 8
  args = _factor_problem(rng, B, nc, nv)
  args = args[:5] + (np.ones((B, nc)),)
  w_u = rng.standard_normal((B, nv))
  w_l = rng.standard_normal((B, nc, 3))

  def loss_j(Jr, Wt, vf, bias):
    u, lam = jpc._mf_pure(Jr, Wt, vf, bias, args[4], args[5], jct.SolverConfig())
    return jnp.sum(w_u * u) + jnp.sum(w_l * lam)

  gj = jax.jit(jax.grad(loss_j, argnums=(0, 1, 2, 3)))(*args[:4])
  xs = [torch.tensor(a, requires_grad=True) for a in args[:4]]
  u, lam = tgc.solve_dynamics_batch(*xs, *_t(args[4], args[5]))
  (torch.sum(torch.tensor(w_u) * u) + torch.sum(torch.tensor(w_l) * lam)).backward()
  for x, g in zip(xs, gj):
    g = np.asarray(g)
    assert np.abs(x.grad.numpy() - g).max() <= TOL * (np.abs(g).max() + 1.0)
