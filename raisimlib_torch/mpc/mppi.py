"""Sampling-based MPC (MPPI) with the whole sample population in one batch.

Counterpart of raisimlib_tpu/mpc/mppi.py (MPPIConfig, _colorize,
mppi_step_batch). K perturbed control sequences per environment roll out
together through a batched dynamics, are weighted by exp(-cost / T) and
averaged. torch cannot reproduce `jax.random`, so the white noise comes from
an explicit `torch.Generator`, or is passed in as `eps_white`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch


@dataclasses.dataclass(frozen=True)
class MPPIConfig:
  n_samples: int = 256
  temperature: float = 1.0
  sigma: float = 0.2            # exploration std-dev per control dim
  smooth: float = 0.7           # exploration noise low-pass (colored noise)
  n_elite: int = 0              # >0: average the n_elite best samples


class MPPISolution(NamedTuple):
  U: torch.Tensor           # (E, H, nu) updated plans
  cost: torch.Tensor        # (E,) cost of the incoming plan (sample 0)
  best_cost: torch.Tensor   # (E,) best sampled rollout cost


def _colorize(eps_white, smooth: float):
  """(..., H, nu) white noise -> low-pass colored, variance-normalised."""
  prev = torch.zeros_like(eps_white[..., 0, :])
  out = []
  for k in range(eps_white.shape[-2]):
    prev = smooth * prev + (1.0 - smooth) * eps_white[..., k, :]
    out.append(prev)
  # steady-state std of s*prev + (1-s)*e is sigma*sqrt((1-s)/(1+s))
  return torch.stack(out, -2) / ((1.0 - smooth) / (1.0 + smooth) + 1e-9) ** 0.5


def mppi_step_batch(
    dyn_b: Callable,
    running_cost: Callable,
    final_cost: Callable,
    x0s: torch.Tensor,      # (E, nx) — E independent MPC problems
    Us: torch.Tensor,       # (E, H, nu) current plans
    generator: Optional[torch.Generator] = None,
    config: MPPIConfig = MPPIConfig(),
    eps_white: Optional[torch.Tensor] = None,
) -> MPPISolution:
  """One MPPI update of E plans, all E*K sample rollouts in ONE physics batch.

  `dyn_b(X, A, t) -> X_next` is a batched dynamics (make_contact_dyn_batch);
  `running_cost(X, A, t) -> (B,)` and `final_cost(X) -> (B,)` are batched.
  `eps_white` (E, K, H, nu), when given, is the already-scaled white noise
  (sigma included); otherwise it is drawn from `generator`. Sample 0 of each
  environment is the unperturbed plan, and `cost` is its cost."""
  E, H, nu = Us.shape
  K = config.n_samples
  if eps_white is None:
    eps_white = config.sigma * torch.randn((E, K, H, nu), generator=generator,
                                           dtype=Us.dtype, device=Us.device)
  eps = _colorize(eps_white, config.smooth)
  eps[:, 0] = 0.0
  Usamp = Us[:, None] + eps                               # (E, K, H, nu)

  X = x0s[:, None, :].expand(E, K, x0s.shape[-1]).reshape(E * K, -1)
  Uflat = Usamp.reshape(E * K, H, nu)
  acc = torch.zeros(E * K, dtype=Us.dtype, device=Us.device)
  for t in range(H):
    acc = acc + running_cost(X, Uflat[:, t], t)
    X = dyn_b(X, Uflat[:, t], t)
  costs = (acc + final_cost(X)).reshape(E, K)

  if config.n_elite > 0:
    top = torch.topk(-costs, config.n_elite, dim=1).indices
    U_new = torch.take_along_dim(Usamp, top[:, :, None, None], 1).mean(1)
  else:
    beta = costs.min(1, keepdim=True).values
    w = torch.exp(-(costs - beta) / config.temperature)
    w = w / w.sum(1, keepdim=True)
    U_new = torch.einsum("ek,ekhu->ehu", w, Usamp)
  return MPPISolution(U=U_new, cost=costs[:, 0], best_cost=costs.min(1).values)
