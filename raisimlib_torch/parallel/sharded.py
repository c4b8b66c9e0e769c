"""Data-parallel sharded rollouts and MPC solves: the port's counterpart of
raisimlib_tpu/parallel/sharded.py.

Each rank holds its shard of the global batch (parallel.mesh.shard_batch)
as plain local tensors, runs its worlds as one physics batch on its own
device, and returns its shard; the only cross-rank traffic is the explicit
metric reductions of the solvers (one all_reduce each). The rollout issues
no collective at all. `parallel.mesh.gather_batch` assembles a global
result where a caller needs one.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from raisimlib_torch.mpc.ilqr import ILQRConfig, ilqr_batch
from raisimlib_torch.mpc.mppi import MPPIConfig, receding_horizon
from raisimlib_torch.mpc.state_map import FUSED_MODES
from raisimlib_torch.ops import gpu_step
from raisimlib_torch.ops.integrator import State


def make_sharded_rollout(scene, mesh, use_pd: bool = False, fused: str = "auto") -> Callable:
  """rollout(states, taus) -> (final_states, q_trace) on this rank's shard.

  `states`: a State of the rank's B_local worlds; `taus`: (B_local, H, nv)
  torques (PD targets with `use_pd`); the horizon is taus.shape[1]. The
  physics runs through the fused step K1 (ops/gpu_step.make_step_batch_fused)
  where `fused="auto"` finds a scene on the card that K1 covers, or always
  with `fused="require"` (FusedStepUnsupported where K1 refuses the scene;
  on the CPU, K1's twin); otherwise through Scene.step_batch, the K2 path.
  q_trace is (B_local, H, nq)."""
  if fused not in FUSED_MODES:
    raise ValueError(f"fused={fused!r}: expected one of {FUSED_MODES}")
  fused_step = None
  if fused == "require" or (fused == "auto" and scene.device.type == "cuda"):
    try:
      fused_step = gpu_step.make_step_batch_fused(scene, use_pd=use_pd)
    except gpu_step.FusedStepUnsupported:
      if fused == "require":
        raise

  def step(s, tau_t, zero):
    if fused_step is not None:
      return fused_step(s, zero, tau_t) if use_pd else fused_step(s, tau_t, None)
    return scene.step_batch(s, zero, tau_t) if use_pd else scene.step_batch(s, tau_t)

  def rollout(states: State, taus: torch.Tensor):
    steps = taus.transpose(0, 1).contiguous()      # time-major, as the JAX package scans
    zero = torch.zeros_like(steps[0])
    s, qs = states, []
    for tau_t in steps:
      s = step(s, tau_t, zero)
      qs.append(s.q)
    return s, torch.stack(qs, 1)

  rollout.fused = fused_step is not None
  return rollout


def _mean_over(mesh, x):
  """The mean over the mesh's ranks of a scalar that is a mean over equal
  shards: one all_reduce (the JAX package's pmean)."""
  dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.group())
  return x / mesh.size


def make_sharded_ilqr(dyn: Callable, running_cost: Callable, final_cost: Callable, mesh,
                      config: ILQRConfig = ILQRConfig(), dyn_fast: Optional[Callable] = None,
                      dyn_diff: Optional[Callable] = None) -> Callable:
  """solve(x0s, U0s) -> (U, cost, metrics): batched iLQR MPC on this rank's
  shard (x0s (E_local, nx), U0s (E_local, H, nu)).

  With `dyn_fast` (and `dyn_diff` for deriv="jvp"), the shard solves
  through ilqr_batch with them: on a contact scene on the card, the
  rollouts, the line search and the FD Jacobian stacks are launches of K1.
  Otherwise each world solves as `ilqr` with `dyn`, all in one batch.
  `metrics` {"mean_cost", "max_cost"} are reduced over the mesh, one
  all_reduce each (pmean and pmax in the JAX package), the same on every
  rank; U and cost stay the rank's."""

  def solve(x0s, U0s):
    fast, diff = (dyn_fast, dyn_diff) if dyn_fast is not None else (dyn, dyn)
    sols = ilqr_batch(fast, diff, running_cost, final_cost, x0s, U0s, config)
    mean_cost = _mean_over(mesh, sols.cost.mean())
    max_cost = sols.cost.max()
    dist.all_reduce(max_cost, op=dist.ReduceOp.MAX, group=mesh.group())
    return sols.U, sols.cost, {"mean_cost": mean_cost, "max_cost": max_cost}

  return solve


def make_sharded_mppi(dyn: Callable, running_cost: Callable, final_cost: Callable, mesh,
                      n_iters: int, config: MPPIConfig = MPPIConfig()) -> Callable:
  """solve(x0s, U0s, generator=None, eps_white=None) -> (U, cost, mean_cost):
  sampling-MPC solves of this rank's scenarios (mppi.receding_horizon, the
  rank's E_local scenarios with their K samples in one physics batch), and
  the mean cost over the mesh (one all_reduce). The noise is drawn from the
  rank's `generator`, or given as `eps_white` (E_local, n_iters, K, H, nu)."""

  def solve(x0s, U0s, generator: Optional[torch.Generator] = None,
            eps_white: Optional[torch.Tensor] = None):
    U, cost, _ = receding_horizon(dyn, running_cost, final_cost, x0s, U0s, generator,
                                  n_iters, config, eps_white=eps_white)
    return U, cost, _mean_over(mesh, cost.mean())

  return solve
