"""The port's iLQR on contact scenes: the jvp Jacobian stack through the pure
contact path (make_contact_dyn_batch(use_kernel=False)) against the JAX
package's, the ANYmal balance problem (mpc/balance_ilqr.py) against
bench.py's, and ilqr_batch through the fused step's twin.

Tolerances: the resting sphere's Jacobians in f64 to atol 1e-9 (both
packages differentiate the same step exactly; a sticking contact is smooth
in the state); ANYmal's jvp stack against its own central differences at
eps 1e-6 to 1e-7 of the entries' scale (truncation ~eps^2, round-off
~1e-16 / eps, from states whose contacts are settled, not at activation);
the batched balance costs to 1e-12 relative against bench.py's, vmapped."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import flatten_jax_scene
from torch_port_util import one_thread  # noqa: F401  (a module fixture)

jilqr = importlib.import_module("raisimlib_tpu.mpc.ilqr")


def test_jvp_jacobians_of_the_resting_sphere_match_jax():
  """tests/test_ilqr_batch.py's resting sphere (0.1 m, 1 kg, 1 cm into the
  ground, dt 4 ms), f64, B = 3 rows with different velocities: the port's
  jvp stack through its pure contact path against the JAX package's
  through its own."""
  from raisimlib_tpu.mpc.state_map import make_contact_dyn_batch as jmake
  from raisimlib_tpu.world import World as JWorld
  from raisimlib_torch.convert import scene_from_numpy
  from raisimlib_torch.mpc.ilqr import batched_dyn_jacobians
  from raisimlib_torch.mpc.state_map import make_contact_dyn_batch

  world = JWorld(dt=0.004, dtype=jnp.float64)
  world.add_ground()
  world.add_sphere(0.1, 1.0, pos=(0.0, 0.0, 0.09))
  jscene = world.compile(joint_limits=False)
  scene = scene_from_numpy(*flatten_jax_scene(jscene), device="cpu", dtype=torch.float64)
  jdyn, nx, nu = jmake(jscene, control_dt=0.004, substeps=1, use_pd=False, use_kernel=False)
  tdyn, tnx, tnu = make_contact_dyn_batch(scene, 0.004, 1, use_pd=False, use_kernel=False)
  assert (tnx, tnu) == (nx, nu) == (13, 0)
  rng = np.random.default_rng(0)
  X = np.tile(np.concatenate([np.asarray(jscene.model.q_init), np.zeros(6)])[None], (3, 1))
  X[:, 7:] += 0.05 * rng.standard_normal((3, 6))
  U = np.zeros((3, nu))
  jfx, jfu = jax.jit(lambda a, b: jilqr.batched_dyn_jacobians(jdyn, a, b, 0))(X, U)
  fx, fu = batched_dyn_jacobians(tdyn, torch.tensor(X), torch.tensor(U), 0)
  assert fx.shape == (3, 13, 13) and fu.shape == (3, 13, 0)
  assert float(np.abs(np.asarray(jfx)).max()) > 0.5
  np.testing.assert_allclose(fx.numpy(), np.asarray(jfx), rtol=0, atol=1e-9)


def _settled_anymal(B, steps, dtype=torch.float64):
  """The balance scene, B standing robots with N(0, 0.1) on the lateral base
  velocity, `steps` PD-hold steps through the pure path (the feet settled
  into contact, away from the activation boundary)."""
  from raisimlib_torch.models import anymal
  from raisimlib_torch.mpc import balance_ilqr as bi
  from raisimlib_torch.mpc.state_map import make_contact_dyn_batch

  scene = bi.balance_scene(dtype=dtype, device="cpu")
  q0 = anymal.standing_q()
  dyn, nx, nu = make_contact_dyn_batch(scene, bi.CONTROL_DT, 1, use_pd=True, use_kernel=False)
  x0s, U0s = bi.balance_starts(q0, B, 1, seed=3)
  X, U = torch.tensor(x0s, dtype=dtype), torch.tensor(U0s[:, 0], dtype=dtype)
  with torch.no_grad():
    for _ in range(steps):
      X = dyn(X, U, 0)
  return scene, dyn, X, U


def test_anymal_jvp_stack_matches_its_central_differences():
  """ANYmal, B = 2, f64, 10 steps into a PD hold: the exact jvp stack
  (49 basis tangents in one forward-mode pass of 98 rows through the pure
  contact path) against central differences at eps 1e-6 through the same
  path."""
  from raisimlib_torch.mpc.ilqr import batched_dyn_jacobians, batched_dyn_jacobians_fd

  _, dyn, X, U = _settled_anymal(2, 10)
  fx, fu = batched_dyn_jacobians(dyn, X, U, 0)
  with torch.no_grad():
    gx, gu = batched_dyn_jacobians_fd(dyn, X, U, 0, eps=1e-6, order=2)
  assert fx.shape == (2, 37, 37) and fu.shape == (2, 37, 12)
  scale = float(max(fx.abs().max(), fu.abs().max()))
  assert scale > 1.0
  np.testing.assert_allclose(fx.numpy(), gx.numpy(), rtol=0, atol=1e-7 * scale)
  np.testing.assert_allclose(fu.numpy(), gu.numpy(), rtol=0, atol=1e-7 * scale)


def test_balance_costs_match_bench():
  """mpc/balance_ilqr.py's batched costs and starts against bench.py's
  _balance_cost (vmapped) and mk(seed) recipe, f64."""
  import bench
  from raisimlib_torch.models import anymal
  from raisimlib_torch.mpc import balance_ilqr as bi

  q0 = np.asarray(anymal.standing_q(), np.float32)
  jrc, jfc, jq_stand = bench._balance_cost(None, q0, jnp.float64)
  rc, fc, q_stand = bi.balance_costs(q0, dtype=torch.float64, device="cpu")
  np.testing.assert_array_equal(q_stand.numpy(), jq_stand)
  x0s, U0s = bi.balance_starts(q0, 8, 5, seed=1)
  rng = np.random.RandomState(1)
  ref = np.tile(np.concatenate([q0, np.zeros(18, np.float32)])[None], (8, 1))
  ref[:, 23] += 0.1 * rng.randn(8).astype(np.float32)
  np.testing.assert_array_equal(x0s, ref)
  np.testing.assert_array_equal(U0s, np.tile(q0[None, None, 7:], (8, 5, 1)))
  rng = np.random.default_rng(2)
  X = x0s.astype(np.float64) + 0.05 * rng.standard_normal(x0s.shape)
  U = U0s[:, 0].astype(np.float64) + 0.1 * rng.standard_normal((8, 12))
  t = np.arange(8)
  np.testing.assert_allclose(rc(torch.tensor(X), torch.tensor(U), torch.tensor(t)).numpy(),
                             np.asarray(jax.vmap(jrc)(X, U, t)), rtol=1e-12)
  np.testing.assert_allclose(fc(torch.tensor(X)).numpy(), np.asarray(jax.vmap(jfc)(X)),
                             rtol=1e-12)


def test_ilqr_batch_through_the_fused_twin():
  """The balance problem through make_contact_dyn_batch(fused="require") on
  the CPU (the fused step's twin, the card's K1 path) with kernel-FD
  derivatives, f32, E = 1, H = 3, 2 iterations: finite, the cost
  non-increasing, each FD stack one call of 2 * 49 * 3 rows."""
  from raisimlib_torch.models import anymal
  from raisimlib_torch.mpc import balance_ilqr as bi
  from raisimlib_torch.mpc.ilqr import ILQRConfig, ilqr_batch
  from raisimlib_torch.mpc.state_map import make_contact_dyn_batch

  f32 = torch.float32
  scene = bi.balance_scene(dtype=f32, device="cpu")
  q0 = anymal.standing_q()
  dyn, nx, nu = make_contact_dyn_batch(scene, bi.CONTROL_DT, 1, use_pd=True, fused="require")
  batches = []

  def dyn_logged(X, U, t):
    batches.append(X.shape[0])
    return dyn(X, U, t)

  rc, fc, _ = bi.balance_costs(q0, dtype=f32, device="cpu")
  x0s, U0s = bi.balance_starts(q0, 1, 3, seed=0)
  sol = ilqr_batch(dyn_logged, None, rc, fc, torch.tensor(x0s), torch.tensor(U0s),
                   ILQRConfig(iters=2, deriv="fd"))
  assert batches == [1] * 3 + ([2 * 49 * 3] + [8] * 3) * 2
  ct = sol.cost_trace.numpy()
  assert np.all(np.isfinite(ct)) and np.all(np.isfinite(sol.X.numpy()))
  assert np.all(ct[:, 1:] <= ct[:, :-1])
