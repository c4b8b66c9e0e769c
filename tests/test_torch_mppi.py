"""The port's batched MPPI update on ANYmal vs the JAX package's, f64, with
JAX's own white-noise draw injected (torch cannot reproduce jax.random). Both
sides roll the samples through make_contact_dyn_batch(use_kernel=False), the
pure step path. Tolerance 1e-8: the same f64 arithmetic end to end, with the
softmax weights amplifying cost round-off by 1/temperature."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from torch_port_util import (jax_anymal_scene, load_golden, perturbed_states,
                             torch_anymal_scene)

E, K, H = 2, 8, 3
TEMP, SIGMA = 0.3, 0.1


def test_mppi_step_batch_matches_jax():
  from raisimlib_tpu.mpc import mppi as jm
  from raisimlib_tpu.mpc import state_map as jsm
  from raisimlib_tpu.ops.spatial import quat_box_minus as jqbm
  from raisimlib_torch.mpc import mppi as tm
  from raisimlib_torch.mpc import state_map as tsm
  from raisimlib_torch.ops.spatial import quat_box_minus as tqbm

  g = load_golden()
  q, u = perturbed_states(g, E, seed=9)
  x0s = np.concatenate([q, u], 1)
  q_stand = g["pd_targets"][0, 6:]
  Us = np.tile(q_stand, (E, H, 1)) + 0.01 * np.random.default_rng(2).standard_normal((E, H, 12))
  z0 = float(g["q0"][2])

  # JAX's draw, exactly as mppi_step_batch makes it
  key = jax.random.PRNGKey(4)
  keys = jax.random.split(key, E)
  eps_white = SIGMA * jax.vmap(lambda k: jax.random.normal(k, (K, H, 12), jnp.float64))(keys)

  def rc_j(x, a, t):
    return (40.0 * (x[2] - z0) ** 2
            + 10.0 * jnp.sum(jqbm(x[3:7], jnp.array([1.0, 0, 0, 0])) ** 2)
            + 0.5 * jnp.sum(x[19:25] ** 2) + jnp.sum((a - q_stand) ** 2)) * 0.01

  def fc_j(x):
    return 200.0 * (x[2] - z0) ** 2 + 5.0 * jnp.sum(x[19:25] ** 2)

  js = jax_anymal_scene()
  dyn_j, _, _ = jsm.make_contact_dyn_batch(js, 0.0025, 1, use_pd=True,
                                           use_kernel=False, fused="never")
  cfg_j = jm.MPPIConfig(n_samples=K, sigma=SIGMA, temperature=TEMP)
  sol_j = jax.jit(lambda x, U: jm.mppi_step_batch(dyn_j, rc_j, fc_j, x, U, key, cfg_j))(
      x0s, Us)

  q_st = torch.tensor(q_stand)
  ident = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=torch.float64)

  def rc_t(X, A, t):
    return (40.0 * (X[:, 2] - z0) ** 2
            + 10.0 * torch.sum(tqbm(X[:, 3:7], ident) ** 2, 1)
            + 0.5 * torch.sum(X[:, 19:25] ** 2, 1) + torch.sum((A - q_st) ** 2, 1)) * 0.01

  def fc_t(X):
    return 200.0 * (X[:, 2] - z0) ** 2 + 5.0 * torch.sum(X[:, 19:25] ** 2, 1)

  ts = torch_anymal_scene()
  dyn_t, nx, nu = tsm.make_contact_dyn_batch(ts, 0.0025, 1, use_pd=True, use_kernel=False)
  assert (nx, nu) == (37, 12)
  with torch.inference_mode():
    sol_t = tm.mppi_step_batch(dyn_t, rc_t, fc_t, torch.tensor(x0s), torch.tensor(Us),
                               config=tm.MPPIConfig(n_samples=K, sigma=SIGMA, temperature=TEMP),
                               eps_white=torch.tensor(np.asarray(eps_white)))
  for a, b in ((sol_t.U, sol_j.U), (sol_t.cost, sol_j.cost),
               (sol_t.best_cost, sol_j.best_cost)):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-8, atol=1e-8)
  # the update moved the plans (the comparison is not of two unchanged inputs)
  assert np.abs(sol_t.U.numpy() - Us).max() > 1e-4


def test_generator_draw_is_reproducible():
  from raisimlib_torch.mpc import mppi as tm

  def dyn(X, A, t):
    return X + 0.1 * A.sum(1, keepdim=True)

  def rc(X, A, t):
    return (X ** 2).sum(1) + (A ** 2).sum(1)

  def fc(X):
    return (X ** 2).sum(1)

  x0 = torch.ones(3, 2, dtype=torch.float64)
  U = torch.zeros(3, 4, 2, dtype=torch.float64)
  cfg = tm.MPPIConfig(n_samples=16)
  a = tm.mppi_step_batch(dyn, rc, fc, x0, U, torch.Generator().manual_seed(1), cfg)
  b = tm.mppi_step_batch(dyn, rc, fc, x0, U, torch.Generator().manual_seed(1), cfg)
  assert torch.equal(a.U, b.U) and a.U.abs().max() > 0
  assert bool((a.best_cost <= a.cost).all())
