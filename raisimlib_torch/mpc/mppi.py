"""Sampling-based MPC (MPPI) with the whole sample population in one batch.

Counterpart of raisimlib_tpu/mpc/mppi.py (MPPIConfig, _colorize, mppi_step,
mppi_step_batch, receding_horizon). K perturbed control sequences per
environment roll out together through a batched dynamics, are weighted by
exp(-cost / T) and averaged. torch cannot reproduce `jax.random`, so the
white noise comes from an explicit `torch.Generator`, or is passed in as
`eps_white`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from raisimlib_torch.utils import profiling


@dataclasses.dataclass(frozen=True)
class MPPIConfig:
  n_samples: int = 256
  temperature: float = 1.0
  sigma: float = 0.2            # exploration std-dev per control dim
  smooth: float = 0.7           # exploration noise low-pass (colored noise)
  n_elite: int = 0              # >0: average the n_elite best samples


class MPPISolution(NamedTuple):
  U: torch.Tensor           # (E, H, nu) updated plans ((H, nu) from mppi_step)
  cost: torch.Tensor        # mppi_step_batch: (E,) cost of the incoming plan (sample 0);
                            # mppi_step: the cost of the updated plan
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


def _draw(generator, config, shape, like):
  return config.sigma * torch.randn(shape, generator=generator, dtype=like.dtype,
                                    device=like.device)


def mppi_step_batch(
    dyn_b: Callable,
    running_cost: Callable,
    final_cost: Callable,
    x0s: torch.Tensor,      # (E, nx) — E independent MPC problems
    Us: torch.Tensor,       # (E, H, nu) current plans
    generator: Optional[torch.Generator] = None,
    config: MPPIConfig = MPPIConfig(),
    eps_white: Optional[torch.Tensor] = None,
    env_ctx: Optional[torch.Tensor] = None,
) -> MPPISolution:
  """One MPPI update of E plans, all E*K sample rollouts in ONE physics batch.

  `dyn_b(X, A, t) -> X_next` is a batched dynamics (make_contact_dyn_batch);
  `running_cost(X, A, t) -> (B,)` and `final_cost(X) -> (B,)` are batched.
  `eps_white` (E, K, H, nu), when given, is the already-scaled white noise
  (sigma included); otherwise it is drawn from `generator`. Sample 0 of each
  environment is the unperturbed plan, and `cost` is its cost.

  `env_ctx`, a tensor with leading dimension E (e.g. each environment's
  terrain heights (E, nx, ny)), is repeated over each environment's K
  samples and passed on as `dyn_b(X, A, t, ctx)`, `running_cost(X, A, t,
  ctx)` and `final_cost(X, ctx)`."""
  E, H, _ = Us.shape
  with profiling.span("mppi.update", E=E, K=config.n_samples, H=H):
    U_new, costs = _sample_update(dyn_b, running_cost, final_cost, x0s, Us, eps_white,
                                  config, generator, env_ctx)
    return MPPISolution(U=U_new, cost=costs[:, 0], best_cost=costs.min(1).values)


def _rollout_costs(dyn_b, running_cost, final_cost, X, U, ctx=()):
  """(N,) costs of N plans U (N, H, nu) from X (N, nx), in one physics batch."""
  acc = torch.zeros(X.shape[0], dtype=U.dtype, device=U.device)
  for t in range(U.shape[1]):
    with profiling.span("mppi.cost"):
      acc = acc + running_cost(X, U[:, t], t, *ctx)
    X = dyn_b(X, U[:, t], t, *ctx)
  with profiling.span("mppi.cost"):
    return acc + final_cost(X, *ctx)


def _sample_update(dyn_b, running_cost, final_cost, x0s, Us, eps_white, config,
                   generator=None, env_ctx=None):
  """The E * K sample rollouts in one physics batch (sample 0 of each
  environment the unperturbed plan) and the weighted (or elite) average:
  (U_new (E, H, nu), costs (E, K)). Without `eps_white` the white noise is
  drawn from `generator`; `env_ctx` is repeated over each environment's
  samples."""
  E, H, nu = Us.shape
  K = config.n_samples
  with profiling.span("mppi.noise"):
    if eps_white is None:
      eps_white = _draw(generator, config, (E, K, H, nu), Us)
    eps = _colorize(eps_white, config.smooth)
    eps[:, 0] = 0.0
    Usamp = Us[:, None] + eps                             # (E, K, H, nu)
    X = x0s[:, None, :].expand(E, K, x0s.shape[-1]).reshape(E * K, -1)
    ctx = () if env_ctx is None else (env_ctx.repeat_interleave(K, 0),)
  costs = _rollout_costs(dyn_b, running_cost, final_cost, X, Usamp.reshape(E * K, H, nu),
                         ctx).reshape(E, K)
  with profiling.span("mppi.weights"):
    if config.n_elite > 0:
      top = torch.topk(-costs, config.n_elite, dim=1).indices
      return torch.take_along_dim(Usamp, top[:, :, None, None], 1).mean(1), costs
    w = torch.exp(-(costs - costs.min(1, keepdim=True).values) / config.temperature)
    return torch.einsum("ek,ekhu->ehu", w / w.sum(1, keepdim=True), Usamp), costs


def _mppi_update(dyn_b, running_cost, final_cost, x0s, Us, eps_white, config, generator=None):
  """mppi_step of E problems at once: the E * K samples in one physics
  batch, then the E updated plans in another. Returns an MPPISolution with
  an E axis; `cost` is the updated plan's."""
  E, H, _ = Us.shape
  with profiling.span("mppi.update", E=E, K=config.n_samples, H=H):
    U_new, costs = _sample_update(dyn_b, running_cost, final_cost, x0s, Us, eps_white,
                                  config, generator)
    cost_new = _rollout_costs(dyn_b, running_cost, final_cost, x0s, U_new)
    return MPPISolution(U=U_new, cost=cost_new, best_cost=costs.min(1).values)


def mppi_step(
    dyn_b: Callable,
    running_cost: Callable,
    final_cost: Callable,
    x0: torch.Tensor,       # (nx,)
    U: torch.Tensor,        # (H, nu)
    generator: Optional[torch.Generator] = None,
    config: MPPIConfig = MPPIConfig(),
    eps_white: Optional[torch.Tensor] = None,
) -> MPPISolution:
  """One MPPI update of the plan U (call repeatedly for receding-horizon
  MPC). The dynamics and costs are batched, as mppi_step_batch takes them;
  the K samples roll out in one batch. `eps_white` (K, H, nu), the scaled
  white noise, or drawn from `generator`. Unlike mppi_step_batch's, the
  returned `cost` is the cost of the UPDATED plan, one more rollout, as in
  the JAX package."""
  sol = _mppi_update(dyn_b, running_cost, final_cost, x0[None], U[None],
                     None if eps_white is None else eps_white[None], config, generator)
  return MPPISolution(*(x[0] for x in sol))


def receding_horizon(
    dyn_b: Callable,
    running_cost: Callable,
    final_cost: Callable,
    x0: torch.Tensor,
    U0: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    n_iters: int = 1,
    config: MPPIConfig = MPPIConfig(),
    eps_white: Optional[torch.Tensor] = None,
):
  """`n_iters` mppi_step updates on a fixed x0 (one MPC solve). Returns
  (U, cost, trace), the last update's plan and cost and every update's cost.

  x0 (nx,) and U0 (H, nu) for one problem, or x0 (E, nx) and U0 (E, H, nu)
  for E problems whose samples share each update's physics batch (E * K
  rows, then E for the updated plans), each solved as on its own.
  `eps_white`, the scaled white noise of every update, is (n_iters, K, H,
  nu), or (E, n_iters, K, H, nu) for E problems; without it each update
  draws (E, K, H, nu) from `generator`."""
  one = x0.ndim == 1
  x0s, Us = (x0[None], U0[None]) if one else (x0, U0)
  if eps_white is not None and one:
    eps_white = eps_white[None]
  trace = []
  for i in range(n_iters):
    e = None if eps_white is None else eps_white[:, i]
    sol = _mppi_update(dyn_b, running_cost, final_cost, x0s, Us, e, config, generator)
    Us = sol.U
    trace.append(sol.cost)
  trace = torch.stack(trace, 1)
  cost = trace[:, -1]
  return (Us[0], cost[0], trace[0]) if one else (Us, cost, trace)
