"""The port's iLQR (mpc/ilqr.py) against the JAX package's, on the problems of
tests/test_ilqr_batch.py and on the cartpole golden.

Tolerances: the Jacobians of the nonlinear toy in f64 to atol 1e-12 (jvp,
exact), 1e-9 (central differences at eps 1e-4: the same f64 arithmetic on
both sides) and 1e-9 (forward differences at eps 1e-6); ilqr_batch on the
linear-quadratic problem to rtol 1e-8 on the cost and atol 1e-7 on U, as
tests/test_ilqr_batch.py holds the JAX package's batched and per-world
solves; the f32 cartpole swing-up within 1e-3 of the golden's torques and
1e-4 of its cost, the gate of tests/test_parity.py."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import load_golden
from torch_port_util import one_thread  # noqa: F401  (a module fixture)

# the module (raisimlib_tpu.mpc exports the function `ilqr` under its name)
jilqr = importlib.import_module("raisimlib_tpu.mpc.ilqr")

DT = 0.1
A = np.array([[1.0, DT], [0.0, 1.0]])
Bm = np.array([[0.0], [DT]])
X0S = np.array([[1.0, 0.0], [-0.5, 0.3], [0.2, -0.8]])
E, H = 3, 40


# ---- the problems, in both packages ----------------------------------------------------


def j_toy(X, U, t):
  return X @ A.T + U @ Bm.T + 0.01 * jnp.sin(X[:, :1]) * jnp.ones_like(X)


def t_toy(X, U, t):
  return X @ torch.tensor(A.T) + U @ torch.tensor(Bm.T) + 0.01 * torch.sin(X[:, :1]) * torch.ones_like(X)


def j_lin(X, U, t):
  return X @ A.T + U @ Bm.T


def t_lin(X, U, t):
  return X @ torch.tensor(A.T) + U @ torch.tensor(Bm.T)


def j_rc(x, u, t):
  return 0.5 * (x @ x) + 0.005 * (u @ u)


def j_fc(x):
  return 5.0 * (x @ x)


def t_rc(X, U, t):
  return 0.5 * (X * X).sum(1) + 0.005 * (U * U).sum(1)


def t_fc(X):
  return 5.0 * (X * X).sum(1)


def _rows(seed, n=6):
  rng = np.random.default_rng(seed)
  return rng.standard_normal((n, 2)), rng.standard_normal((n, 1))


def _jax_solve(dyn_fast, dyn_diff, cfg, rc=j_rc, x0s=X0S):
  return jax.jit(lambda x, U: jilqr.ilqr_batch(dyn_fast, dyn_diff, rc, j_fc, x, U, cfg))(
      jnp.asarray(x0s), jnp.zeros((len(x0s), H, 1)))


def _torch_solve(dyn_fast, dyn_diff, cfg, rc=t_rc, x0s=X0S):
  from raisimlib_torch.mpc.ilqr import ilqr_batch

  return ilqr_batch(dyn_fast, dyn_diff, rc, t_fc, torch.tensor(x0s),
                    torch.zeros((len(x0s), H, 1), dtype=torch.float64), cfg)


def _same(sol_t, sol_j, rtol=1e-8, atol_u=1e-7, reg=False):
  """Cost, cost trace, U and X agree; with `reg`, the reg trace too (not
  after convergence, where a step's acceptance is a round-off decision)."""
  np.testing.assert_allclose(sol_t.cost.numpy(), np.asarray(sol_j.cost), rtol=rtol)
  np.testing.assert_allclose(sol_t.cost_trace.numpy(), np.asarray(sol_j.cost_trace), rtol=rtol)
  if reg:
    np.testing.assert_allclose(sol_t.reg_trace.numpy(), np.asarray(sol_j.reg_trace), rtol=rtol)
  np.testing.assert_allclose(sol_t.U.numpy(), np.asarray(sol_j.U), atol=atol_u)
  np.testing.assert_allclose(sol_t.X.numpy(), np.asarray(sol_j.X), atol=atol_u)


# ---- the Jacobian stacks -----------------------------------------------------------------


def test_jvp_jacobians_match_jax():
  from raisimlib_torch.mpc.ilqr import batched_dyn_jacobians

  X, U = _rows(0)
  fx, fu = batched_dyn_jacobians(t_toy, torch.tensor(X), torch.tensor(U), 0)
  jfx, jfu = jilqr.batched_dyn_jacobians(j_toy, jnp.asarray(X), jnp.asarray(U), 0)
  assert fx.shape == (6, 2, 2) and fu.shape == (6, 2, 1)
  np.testing.assert_allclose(fx.numpy(), np.asarray(jfx), rtol=0, atol=1e-12)
  np.testing.assert_allclose(fu.numpy(), np.asarray(jfu), rtol=0, atol=1e-12)


@pytest.mark.parametrize("order,eps", [(2, 1e-4), (1, 1e-6)])
def test_fd_jacobians_match_jax(order, eps):
  """Both difference orders, with the JAX package's rows: the same rows in
  the same order go through the dynamics, so the stacks agree to f64
  round-off over eps."""
  from raisimlib_torch.mpc.ilqr import batched_dyn_jacobians_fd

  X, U = _rows(order)
  calls = []

  def toy_logged(Xb, Ub, t):
    calls.append((Xb.numpy().copy(), Ub.numpy().copy()))
    return t_toy(Xb, Ub, t)

  fx, fu = batched_dyn_jacobians_fd(toy_logged, torch.tensor(X), torch.tensor(U), 0, eps, order)
  jfx, jfu = jilqr.batched_dyn_jacobians_fd(j_toy, jnp.asarray(X), jnp.asarray(U), 0, eps, order)
  np.testing.assert_allclose(fx.numpy(), np.asarray(jfx), rtol=0, atol=1e-9)
  np.testing.assert_allclose(fu.numpy(), np.asarray(jfu), rtol=0, atol=1e-9)
  # one call, direction-major then row: 2 nd B rows (central) or (nd + 1) B
  (Xb, Ub), = calls
  nd = 3
  assert Xb.shape == ((2 * nd if order == 2 else nd + 1) * 6, 2)
  np.testing.assert_array_equal(Xb[6:12, 0] - X[:, 0], 0.0)       # direction 1: x_1 only
  np.testing.assert_allclose(Xb[6:12, 1] - X[:, 1], eps, rtol=1e-9)
  np.testing.assert_allclose(Ub[12:18, 0] - U[:, 0], eps, rtol=1e-6)  # direction 2: u


def test_fd_order_must_be_1_or_2():
  from raisimlib_torch.mpc.ilqr import batched_dyn_jacobians_fd

  X, U = _rows(0)
  with pytest.raises(ValueError, match="order 3"):
    batched_dyn_jacobians_fd(t_toy, torch.tensor(X), torch.tensor(U), 0, 1e-3, 3)


# ---- the solves ------------------------------------------------------------------------------


@pytest.mark.parametrize("deriv", ["jvp", "fd"])
def test_ilqr_batch_matches_jax_on_the_lq_problem(deriv):
  """E = 3 linear-quadratic problems, H = 40, 6 iterations, f64: the port's
  ilqr_batch against the JAX package's (jvp: dyn_diff the linear map; fd:
  eps 1e-4, exact on a linear map up to round-off)."""
  from raisimlib_torch.mpc.ilqr import ILQRConfig

  cfg = dict(iters=6, deriv=deriv, fd_eps=1e-4)
  sol_t = _torch_solve(t_lin, t_lin if deriv == "jvp" else None, ILQRConfig(**cfg))
  sol_j = _jax_solve(j_lin, j_lin if deriv == "jvp" else None, jilqr.ILQRConfig(**cfg))
  assert sol_t.U.shape == (E, H, 1) and sol_t.cost_trace.shape == (E, 6)
  assert sol_t.gains_K.shape == (E, H, 1, 2)
  _same(sol_t, sol_j)
  ct = sol_t.cost_trace.numpy()
  assert np.all(ct[:, 1:] <= ct[:, :-1] + 1e-10)


def test_ilqr_is_ilqr_batch_at_one_env():
  """ilqr (one problem, dyn_diff = dyn) against the JAX package's ilqr on
  the nonlinear toy, f64."""
  from raisimlib_torch.mpc.ilqr import ILQRConfig, ilqr

  def j_toy1(x, u, t):
    return j_toy(x[None], u[None], t)[0]

  x0 = X0S[1]
  sol_t = ilqr(t_toy, t_rc, t_fc, torch.tensor(x0), torch.zeros((H, 1), dtype=torch.float64),
               ILQRConfig(iters=6))
  sol_j = jax.jit(lambda x, U: jilqr.ilqr(j_toy1, j_rc, j_fc, x, U, jilqr.ILQRConfig(iters=6)))(
      jnp.asarray(x0), jnp.zeros((H, 1)))
  assert sol_t.U.shape == (H, 1) and sol_t.cost.shape == ()
  _same(sol_t, sol_j)


def test_non_pd_quu_is_rejected_as_in_jax():
  """A running cost concave in u (-1.0 u.u) makes Quu + reg I indefinite at
  every step: each iteration is rejected, the plan stays, and reg rises by
  reg_up each time, as in the JAX package."""
  from raisimlib_torch.mpc.ilqr import ILQRConfig

  def j_rc_concave(x, u, t):
    return 0.5 * (x @ x) - 1.0 * (u @ u)

  def t_rc_concave(X, U, t):
    return 0.5 * (X * X).sum(1) - 1.0 * (U * U).sum(1)

  sol_t = _torch_solve(t_lin, t_lin, ILQRConfig(iters=4), rc=t_rc_concave)
  sol_j = _jax_solve(j_lin, j_lin, jilqr.ILQRConfig(iters=4), rc=j_rc_concave)
  _same(sol_t, sol_j, reg=True)
  np.testing.assert_allclose(sol_t.reg_trace.numpy(), 1e-6 * 8.0 ** np.arange(1, 5)[None]
                             .repeat(E, 0), rtol=1e-12)
  np.testing.assert_array_equal(sol_t.U.numpy(), 0.0)
  assert np.all(sol_t.cost_trace.numpy() == sol_t.cost_trace.numpy()[:, :1])


def test_nan_candidate_is_rejected_as_in_jax():
  """A line-search candidate whose rollout turns NaN (here: any control
  beyond 2.0, which the full Newton step reaches and the shorter ones do
  not) wins argmin on both sides (the first NaN, as numpy's argmin) and then
  fails the finiteness test: the iteration is rejected even though smaller
  steps would have lowered the cost, and reg rises."""
  from raisimlib_torch.mpc.ilqr import ILQRConfig

  def j_cliff(X, U, t):
    return jnp.where(jnp.abs(U) > 2.0, jnp.nan, 1.0) * j_lin(X, U, t)

  def t_cliff(X, U, t):
    return torch.where(U.abs() > 2.0, float("nan"), 1.0) * t_lin(X, U, t)

  x0s = X0S * 5.0
  sol_t = _torch_solve(t_cliff, t_lin, ILQRConfig(iters=5), x0s=x0s)
  sol_j = _jax_solve(j_cliff, j_lin, jilqr.ILQRConfig(iters=5), x0s=x0s)
  _same(sol_t, sol_j, reg=True)
  rt = sol_t.reg_trace.numpy()
  assert np.any(rt[:, 0] > 1e-6), "no env met a NaN candidate in its first iteration"
  first = rt[:, 0] > 1e-6
  c0 = _torch_solve(t_lin, t_lin, ILQRConfig(iters=0), x0s=x0s).cost.numpy()
  np.testing.assert_array_equal(sol_t.cost_trace.numpy()[first, 0], c0[first])
  assert np.all(np.isfinite(sol_t.cost.numpy()))


def test_torch_argmin_takes_the_first_nan_or_minimum():
  """The line search's selection: torch.argmin as jnp.argmin, the first NaN
  if there is one, else the first minimum."""
  c = [[1.0, np.nan, 0.0, np.nan], [3.0, 1.0, 1.0, 2.0]]
  assert torch.argmin(torch.tensor(c), 1).tolist() == np.asarray(
      jnp.argmin(jnp.asarray(c), 1)).tolist() == [1, 1]


def test_deriv_path_errors():
  """deriv="jvp" without a dyn_diff raises (the JAX package silently uses
  finite differences there); an unknown deriv raises, as in JAX."""
  from raisimlib_torch.mpc.ilqr import ILQRConfig

  with pytest.raises(ValueError, match="dyn_diff"):
    _torch_solve(t_lin, None, ILQRConfig(iters=1, deriv="jvp"))
  with pytest.raises(ValueError, match="unknown deriv"):
    _torch_solve(t_lin, t_lin, ILQRConfig(iters=1, deriv="exact"))


# ---- the cartpole swing-up against its golden -------------------------------------------------


def test_cartpole_f32_solve_meets_the_golden():
  """BASELINE config 1 in float32 through the port (make_smooth_dyn at dt
  0.02, 2 substeps; ilqr, 40 iterations, H = 50) against
  tests/goldens/cartpole_swingup.npz (the f64 solve): max |dU| <= 1e-3,
  the cost within 1e-4, the pole within 0.5 rad of upright."""
  from raisimlib_torch.examples.cartpole_swingup import cartpole_costs
  from raisimlib_torch.models import primitives
  from raisimlib_torch.mpc import ILQRConfig, ilqr, make_smooth_dyn

  g = load_golden("cartpole_swingup.npz")
  f32 = torch.float32
  model = primitives.cartpole(dtype=f32, device="cpu")
  dyn, nx, nu = make_smooth_dyn(model, [0.0, 0.0, -9.81], dt=0.02, substeps=2)
  rc, fc = cartpole_costs({"upright": 4.0, "cart": 0.1, "vel": 0.05, "effort": 0.01,
                           "final_upright": 40.0}, 0.02)
  sol = ilqr(dyn, rc, fc, torch.tensor(g["x0"], dtype=f32), torch.zeros((int(g["H"]), nu), dtype=f32),
             ILQRConfig(iters=40))
  dU = np.abs(sol.U.numpy().astype(np.float64) - g["U"])
  assert dU.max() <= 1e-3, f"max|dU|={dU.max():.2e}"
  assert abs(float(sol.cost) - float(g["cost"])) <= 1e-4
  assert abs(float(sol.X[-1, 1]) - np.pi) < 0.5
  assert np.all(np.diff(sol.cost_trace.numpy()) <= 0.0)
