"""Simulation state of a batch of worlds.

Counterpart of raisimlib_tpu/ops/integrator.py (State, init_state, and the
contact-free semi-implicit Euler step `step_smooth`).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class State:
  q: torch.Tensor  # (..., nq)
  u: torch.Tensor  # (..., nv)
  t: torch.Tensor  # (...) simulation time


def init_state(model, q=None, u=None) -> State:
  """State at q (default: the model's q_init) and u (default: zero)."""
  q = model.q_init.clone() if q is None else torch.as_tensor(
      q, dtype=model.dtype, device=model.device)
  u = (torch.zeros(q.shape[:-1] + (model.nv,), dtype=q.dtype, device=q.device)
       if u is None else torch.as_tensor(u, dtype=q.dtype, device=q.device))
  return State(q=q, u=u, t=torch.zeros(q.shape[:-1], dtype=q.dtype, device=q.device))


def step_smooth(model, state: State, tau, gravity, dt, f_ext_w=None) -> State:
  """Contact-free semi-implicit Euler step of a batch of worlds (q (B, nq),
  u, tau (B, nv)): the torques masked to the actuated dofs and clipped to
  their limits, qdd by ABA, then u' = u + dt qdd and q' = q (+) u' dt."""
  from raisimlib_torch.ops import dynamics

  tau = torch.clamp(tau * model.actuated, -model.torque_limit, model.torque_limit)
  qdd = dynamics.aba(model, state.q, state.u, tau, gravity, f_ext_w)
  u_new = state.u + dt * qdd
  q_new = dynamics.integrate_q(model, state.q, u_new, dt)
  return State(q=q_new, u=u_new, t=state.t + dt)
