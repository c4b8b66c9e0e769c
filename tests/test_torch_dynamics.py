"""Port's batched dynamics vs the JAX package's vmapped single-world functions
on random f64 ANYmal states. Tolerance 1e-10: the two evaluate the same
recursions in f64 and differ only in summation order (round-off ~1e-15
relative on quantities of order 1-100)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import jax_anymal_scene, torch_anymal_scene

TOL = 1e-10
B = 5


@pytest.fixture(scope="module")
def setup():
  js, ts = jax_anymal_scene(), torch_anymal_scene()
  rng = np.random.default_rng(7)
  q = np.tile(np.asarray(js.model.q_init), (B, 1))
  q[:, :3] += 0.3 * rng.standard_normal((B, 3))
  q[:, 3:7] = rng.standard_normal((B, 4))
  q[:, 3:7] /= np.linalg.norm(q[:, 3:7], axis=1, keepdims=True)
  q[:, 7:] += 0.5 * rng.standard_normal((B, 12))
  u = rng.standard_normal((B, 18))
  return js, ts, q, u


def _close(a, b):
  np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=TOL)


def test_fk(setup):
  from raisimlib_tpu.ops import dynamics as jd
  from raisimlib_torch.ops import dynamics as td

  js, ts, q, u = setup
  kj = jax.jit(jax.vmap(lambda a, b: jd.fk(js.model, a, b)))(q, u)
  kt = td.fk(ts.model, torch.tensor(q), torch.tensor(u))
  for f in ("R", "p", "S_w", "vel6", "Xup_E", "Xup_r"):
    _close(getattr(kt, f).numpy(), getattr(kj, f))


def test_rnea_and_nonlinearities(setup):
  from raisimlib_tpu.ops import dynamics as jd
  from raisimlib_torch.ops import dynamics as td

  js, ts, q, u = setup
  qdd = np.random.default_rng(3).standard_normal((B, 18))
  tj = jax.jit(jax.vmap(lambda a, b, c: jd.rnea(js.model, a, b, c, js.gravity)))(q, u, qdd)
  tt = td.rnea(ts.model, torch.tensor(q), torch.tensor(u), torch.tensor(qdd), ts.gravity)
  _close(tt.numpy(), tj)
  hj = jax.jit(jax.vmap(lambda a, b: jd.nonlinearities(js.model, a, b, js.gravity)))(q, u)
  ht = td.nonlinearities(ts.model, torch.tensor(q), torch.tensor(u), ts.gravity)
  _close(ht.numpy(), hj)


def test_crba_w(setup):
  from raisimlib_tpu.ops import dynamics as jd
  from raisimlib_torch.ops import dynamics as td

  js, ts, q, _ = setup
  Mj = jax.jit(jax.vmap(lambda a: jd.crba_w(js.model, a)))(q)
  Mt = td.crba_w(ts.model, torch.tensor(q))
  _close(Mt.numpy(), Mj)
  # and the Featherstone recursion agrees (same M, another algorithm)
  _close(Mt.numpy(), jax.jit(jax.vmap(lambda a: jd.crba(js.model, a)))(q))


@pytest.mark.parametrize("body", [0, 3, 12])
def test_point_jacobian(setup, body):
  from raisimlib_tpu.ops import dynamics as jd
  from raisimlib_torch.ops import dynamics as td

  js, ts, q, u = setup
  pt = np.random.default_rng(body).standard_normal((B, 3))
  Jj = jax.jit(jax.vmap(lambda a, b, p: jd.point_jacobian(
      js.model, jd.fk(js.model, a, b), body, p)))(q, u, pt)
  Jt = td.point_jacobian(ts.model, td.fk(ts.model, torch.tensor(q), torch.tensor(u)),
                         body, torch.tensor(pt))
  _close(Jt.numpy(), Jj)


def test_integrate_q(setup):
  from raisimlib_tpu.ops import dynamics as jd
  from raisimlib_torch.ops import dynamics as td

  js, ts, q, u = setup
  qj = jax.jit(jax.vmap(lambda a, b: jd.integrate_q(js.model, a, b, 0.01)))(q, u)
  qt = td.integrate_q(ts.model, torch.tensor(q), torch.tensor(u), 0.01)
  _close(qt.numpy(), qj)


def test_linalg_matches_jax():
  from raisimlib_tpu.ops import linalg as jl
  from raisimlib_torch.ops import linalg as tl

  rng = np.random.default_rng(1)
  A = rng.standard_normal((3, 18, 18))
  M = A @ A.transpose(0, 2, 1) + np.eye(18)
  Bm = rng.standard_normal((3, 18, 7))
  Lj = jl.chol(jnp.asarray(M))
  Lt = tl.chol(torch.tensor(M))
  _close(Lt.numpy(), Lj)
  _close(tl.cho_solve(Lt, torch.tensor(Bm)).numpy(), jl.cho_solve(Lj, jnp.asarray(Bm)))
  _close(tl.solve_lower(Lt, torch.eye(18, dtype=torch.float64)).numpy(),
         jl.solve_lower(Lj, jnp.eye(18)))


@pytest.mark.parametrize("flag", ["allow_tf32", "precision"])
def test_compile_refuses_reduced_precision_matmuls(flag):
  """A reduced-precision matmul zeroed an inertia term and made M singular;
  World.compile() raises instead of running (and instead of resetting the
  process-wide flag), and works again once the flag is restored."""
  from raisimlib_torch.world import World

  prev_tf32 = torch.backends.cuda.matmul.allow_tf32
  prev_prec = torch.get_float32_matmul_precision()
  try:
    if flag == "allow_tf32":
      torch.backends.cuda.matmul.allow_tf32 = True
    else:
      torch.set_float32_matmul_precision("high")
    with pytest.raises(RuntimeError, match="mass matrix"):
      World(device="cpu").compile()
  finally:
    torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    torch.set_float32_matmul_precision(prev_prec)
  World(device="cpu").compile()
