"""Flat state vectors and batched contact dynamics for MPC.

Counterpart of raisimlib_tpu/mpc/state_map.py (state_to_vec, vec_to_state,
make_contact_dyn_batch). The optimiser works on flat vectors x = [q, u];
quaternions are renormalised by the dynamics each step.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from raisimlib_torch.ops import gpu_step, pipeline
from raisimlib_torch.ops.integrator import State

FUSED_MODES = ("auto", "require", "never")


def state_to_vec(state: State) -> torch.Tensor:
  return torch.cat([state.q, state.u], -1)


def vec_to_state(model, x: torch.Tensor, t=0.0) -> State:
  t = torch.full(x.shape[:-1], float(t), dtype=x.dtype, device=x.device)
  return State(q=x[..., :model.nq], u=x[..., model.nq:], t=t)


def _on_card(scene) -> bool:
  return scene.device.type == "cuda"


def make_contact_dyn_batch(scene, control_dt: float, substeps: int,
                           use_pd: bool = True, use_kernel: bool = True,
                           fused: str = "auto"):
  """Batched `dyn_b(X, A, t, ctx=None) -> X_next` for X (B, nx), A (B, nu),
  rolling `substeps` physics steps per control step. `ctx`, on a heightmap
  scene, is the per-row terrain heights (B, nx, ny), passed to either step
  path as its `field_heights` (None: the scene's field).

  A holds PD joint-position targets of the actuated dofs if `use_pd`, else
  their torques. The physics step is chosen as in the JAX package:

    * `fused="auto"` (default): a scene on the card whose class the fused
      kernel covers steps with ops/gpu_step.make_step_batch_fused (K1, one
      launch per physics step); an ineligible card scene warns once with the
      reason and uses pipeline.step_batch (the K2 path); a CPU scene uses
      pipeline.step_batch, whose solve runs the K2 twin;
    * `fused="require"`: K1 or FusedStepUnsupported (on the CPU, K1's twin);
    * `fused="never"`: pipeline.step_batch.

  `use_kernel=False` runs pipeline.step_batch with the differentiable
  reference solve, and ignores `fused`. Returns (dyn_b, nx, nu)."""
  if fused not in FUSED_MODES:
    raise ValueError(f"fused={fused!r}: expected one of {FUSED_MODES}")
  model = scene.model
  act_idx = torch.as_tensor(
      np.nonzero(model.actuated.detach().cpu().numpy() > 0.5)[0], device=scene.device)
  nu = len(act_idx)
  nq = model.nq
  if abs(scene.dt * substeps - control_dt) > 1e-9:
    raise ValueError(f"scene.dt * substeps ({scene.dt}*{substeps}) must equal "
                     f"control_dt {control_dt}")

  fused_step = None
  if use_kernel and (fused == "require" or (fused == "auto" and _on_card(scene))):
    try:
      fused_step = gpu_step.make_step_batch_fused(scene, use_pd=use_pd)
    except gpu_step.FusedStepUnsupported as e:
      if fused == "require":
        raise
      warnings.warn(f"the fused step (K1) does not cover this scene ({e}); "
                    "stepping with pipeline.step_batch", stacklevel=2)

  def step(s, tau, pd, ctx):
    if fused_step is not None:
      return fused_step(s, tau, pd, field_heights=ctx)
    return pipeline.step_batch(scene, s, tau, pd, field_heights=ctx, use_kernel=use_kernel)

  def dyn_b(X, A, t, ctx=None):
    B = X.shape[0]
    s = State(q=X[:, :nq], u=X[:, nq:], t=torch.zeros(B, dtype=X.dtype, device=X.device))
    full = torch.zeros((B, model.nv), dtype=X.dtype, device=X.device)
    full[:, act_idx] = A
    zeros_tau = torch.zeros_like(full)
    for _ in range(substeps):
      s = step(s, zeros_tau, full, ctx) if use_pd else step(s, full, None, ctx)
    return torch.cat([s.q, s.u], 1)

  return dyn_b, model.nq + model.nv, nu
