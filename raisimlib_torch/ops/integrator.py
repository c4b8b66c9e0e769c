"""Simulation state of a batch of worlds.

Counterpart of raisimlib_tpu/ops/integrator.py (State, init_state); the
contact-free `step_smooth` waits with `aba`.
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
