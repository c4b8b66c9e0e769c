"""Glue: iLQR-ready dynamics from a RobotModel's smooth (contact-free) step.

Counterpart of raisimlib_tpu/mpc/smooth.py, batched: for models without
quaternion states (all REVOLUTE/PRISMATIC: cartpole, pendulums) the iLQR
state is x = [q, u], and `dyn` maps rows X (B, nx), U (B, nu) to (B, nx).
Floating bases use mpc/state_map.py instead.
"""

from __future__ import annotations

import numpy as np
import torch

from raisimlib_torch.models.model import JointType, RobotModel
from raisimlib_torch.ops import dynamics


def actuated_indices(model: RobotModel) -> np.ndarray:
  return np.nonzero(model.actuated.detach().cpu().numpy() > 0.5)[0]


def make_smooth_dyn(model: RobotModel, gravity, dt: float, substeps: int = 1):
  """Returns (dyn, nx, nu): dyn(X, U, t) -> X_next, `substeps` semi-implicit
  ABA steps of dt / substeps with the controls U as the actuated dofs'
  torques. It is differentiable in forward and reverse mode."""
  if any(JointType(j) == JointType.FREE for j in model.joint_types):
    raise ValueError("make_smooth_dyn is for Euclidean-state models; floating bases use "
                     "mpc/state_map.py")
  act = actuated_indices(model)
  nu, nq, nv = len(act), model.nq, model.nv
  col = {int(d): k for k, d in enumerate(act)}     # dof -> control column
  g = torch.as_tensor(gravity, dtype=model.dtype, device=model.device)
  h = dt / substeps

  def dyn(X, U, t):
    del t
    q, v = X[:, :nq], X[:, nq:]
    zero = torch.zeros_like(v[:, 0])
    tau = torch.stack([U[:, col[d]] if d in col else zero for d in range(nv)], 1)
    for _ in range(substeps):
      qdd = dynamics.aba(model, q, v, tau, g)
      v = v + h * qdd
      q = dynamics.integrate_q(model, q, v, h)
    return torch.cat([q, v], 1)

  return dyn, nq + nv, nu
