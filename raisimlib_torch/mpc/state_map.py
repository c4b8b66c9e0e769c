"""Flat state vectors and batched contact dynamics for MPC.

Counterpart of raisimlib_tpu/mpc/state_map.py (state_to_vec, vec_to_state,
make_contact_dyn_batch). The optimiser works on flat vectors x = [q, u];
quaternions are renormalised by the dynamics each step.
"""

from __future__ import annotations

import numpy as np
import torch

from raisimlib_torch.ops import pipeline
from raisimlib_torch.ops.integrator import State


def state_to_vec(state: State) -> torch.Tensor:
  return torch.cat([state.q, state.u], -1)


def vec_to_state(model, x: torch.Tensor, t=0.0) -> State:
  t = torch.full(x.shape[:-1], float(t), dtype=x.dtype, device=x.device)
  return State(q=x[..., :model.nq], u=x[..., model.nq:], t=t)


def make_contact_dyn_batch(scene, control_dt: float, substeps: int,
                           use_pd: bool = True, use_kernel: bool = True):
  """Batched `dyn_b(X, A, t) -> X_next` for X (B, nx), A (B, nu), rolling
  `substeps` physics steps of `pipeline.step_batch` per control step.

  A holds PD joint-position targets of the actuated dofs if `use_pd`, else
  their torques. `use_kernel=False` runs the differentiable reference solve.
  Returns (dyn_b, nx, nu)."""
  model = scene.model
  act_idx = torch.as_tensor(
      np.nonzero(model.actuated.detach().cpu().numpy() > 0.5)[0], device=scene.device)
  nu = len(act_idx)
  nq = model.nq
  if abs(scene.dt * substeps - control_dt) > 1e-9:
    raise ValueError(f"scene.dt * substeps ({scene.dt}*{substeps}) must equal "
                     f"control_dt {control_dt}")

  def dyn_b(X, A, t):
    B = X.shape[0]
    s = State(q=X[:, :nq], u=X[:, nq:], t=torch.zeros(B, dtype=X.dtype, device=X.device))
    full = torch.zeros((B, model.nv), dtype=X.dtype, device=X.device)
    full[:, act_idx] = A
    zeros_tau = torch.zeros_like(full)
    for _ in range(substeps):
      if use_pd:
        s = pipeline.step_batch(scene, s, zeros_tau, full, use_kernel=use_kernel)
      else:
        s = pipeline.step_batch(scene, s, full, use_kernel=use_kernel)
    return torch.cat([s.q, s.u], 1)

  return dyn_b, model.nq + model.nv, nu
