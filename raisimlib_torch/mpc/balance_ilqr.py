"""The ANYmal balance iLQR problem: the JAX package's iLQR workload
(bench.py::bench_anymal_ilqr) as the port's batched problem.

ANYmal on the ground plane with PD gains kp 100, kd 2 at dt = 0.01 s
(bench.py::_balance_scene(dt=0.01)); one control step is one physics step
with the PD targets of the 12 joints as the controls. The costs are
bench.py::_balance_cost, batched (B rows in, (B,) costs out); the starts are
its `mk(seed)`: the standing pose, every env's lateral base velocity drawn
from N(0, 0.1) by a numpy RandomState(seed), the plan the standing targets.
"""

from __future__ import annotations

import numpy as np
import torch

CONTROL_DT = 0.01
KP, KD = 100.0, 2.0


def balance_scene(dtype=torch.float32, device=None):
  """ANYmal on the ground plane at dt = CONTROL_DT, kp KP, kd KD, on
  `device` (None: the card)."""
  from raisimlib_torch.models import anymal
  from raisimlib_torch.models.urdf import load_urdf
  from raisimlib_torch.world import World

  bodies, geoms, _ = load_urdf(anymal.anymal_urdf())
  world = World(dt=CONTROL_DT, dtype=dtype, device=device)
  world.add_articulated_system(bodies, name="anymal", geoms=geoms)
  world.add_ground()
  return world.compile().set_pd_gains(KP, KD)


def balance_costs(q0, dtype=torch.float32, device=None):
  """Batched running and final costs of bench.py::_balance_cost about the
  standing pose q0 (19,): rc(X, U, t) -> (B,), fc(X) -> (B,); and the
  standing joint targets q_stand (12,) as a tensor."""
  from raisimlib_torch.ops.spatial import quat_box_minus

  q_stand = torch.as_tensor(np.asarray(q0[7:]), dtype=dtype, device=device)
  z0 = float(q0[2])
  quat_id = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)

  def rc(X, U, t):
    q, v = X[:, :19], X[:, 19:]
    return (40.0 * (q[:, 2] - z0) ** 2
            + 10.0 * torch.sum(quat_box_minus(q[:, 3:7], quat_id) ** 2, 1)
            + 0.5 * torch.sum(v[:, :6] ** 2, 1)
            + 1.0 * torch.sum((U - q_stand) ** 2, 1)) * CONTROL_DT

  def fc(X):
    q, v = X[:, :19], X[:, 19:]
    return 200.0 * (q[:, 2] - z0) ** 2 + 5.0 * torch.sum(v[:, :6] ** 2, 1)

  return rc, fc, q_stand


def balance_starts(q0, n_env: int, H: int, seed: int):
  """bench.py's `mk(seed)` as float32 numpy: x0s (n_env, 37), the standing
  state with N(0, 0.1) on each env's lateral base velocity (u[4]); U0s
  (n_env, H, 12), the standing targets."""
  rng = np.random.RandomState(seed)
  x0 = np.concatenate([np.asarray(q0, np.float32), np.zeros(18, np.float32)])
  x0s = np.tile(x0[None], (n_env, 1)).astype(np.float32)
  x0s[:, 19 + 4] += 0.1 * rng.randn(n_env).astype(np.float32)
  U0s = np.tile(np.asarray(q0[7:], np.float32)[None, None, :], (n_env, H, 1))
  return x0s, U0s.astype(np.float32)
