"""BASELINE config 5: an Atlas-class humanoid, 1024 robots batched on one card.

Counterpart of the single-card part of examples/atlas_batch.py. One Atlas
(23 actuated dofs, 29 in all; 32 contact slots, the corners of the pelvis,
torso and feet boxes against the ground, and 23 joint-limit rows) is
compiled once, and the batch of B perturbed standing robots steps together
under the per-group PD hold. Atlas is in the fused step's class, so the
batch steps through make_step_batch_fused (K1a at nv = 29 on the card, one
launch a step; its plain twin on the CPU); where the fused step refuses the
scene it falls back to Scene.step_batch (the K2 path), and the record's
`step_path` says which ran. The sharded weak-scaling table (`--scaling`)
is not ported yet (ROADMAP.md item 15).

Run:  python3 -m raisimlib_torch.examples.atlas_batch [--smoke] [--device cpu]
"""

from __future__ import annotations

import os
import time

import torch

from raisimlib_torch.examples import METRICS_DIR, build_kernels, cli, gate, sync


def build_scene(dtype=torch.float32, device=None):
  """The scenario's Atlas scene, its standing q0 and the scenario."""
  from raisimlib_torch import scenarios

  cfg = scenarios.load("atlas_batch")
  scene, info = scenarios.build_scene(cfg, dtype=dtype, device=device)
  q0 = torch.as_tensor(info["standing_q"]["atlas"], dtype=dtype, device=scene.device)
  return scene, q0, cfg


def batch_states(scene, q0, B: int, generator):
  """B robots at q0 with N(0, 0.01) on every q entry (as the JAX example)."""
  from raisimlib_torch.ops.integrator import State

  q = q0 + 0.01 * torch.randn((B, q0.numel()), generator=generator, dtype=q0.dtype,
                              device=q0.device)
  return State(q=q, u=torch.zeros((B, scene.model.nv), dtype=q0.dtype, device=q0.device),
               t=torch.zeros(B, dtype=q0.dtype, device=q0.device))


def run(smoke: bool = False, scaling: bool = False, device=None,
        metrics_path: str = os.path.join(METRICS_DIR, "atlas_batch.jsonl")) -> dict:
  """B x H batched steps of the PD hold at the scenario's sizes (its smoke
  sizes with `smoke`), timed as the JAX example times them: after a warm-up
  rollout, the better of two rollouts from perturbed states. A full-size
  run asserts that more than 99% of the robots stand (pelvis above 0.9 m)."""
  from raisimlib_torch._device import resolve_device
  from raisimlib_torch.ops import gpu_step
  from raisimlib_torch.ops.integrator import State
  from raisimlib_torch.utils import metrics

  if scaling:
    raise NotImplementedError("the sharded weak-scaling table of atlas_batch is not ported "
                              "to raisimlib_torch yet: ROADMAP.md item 15")
  dev = resolve_device(device)
  scene, q0, cfg = build_scene(torch.float32, dev)
  rcfg = cfg["run"]
  B = int(rcfg["smoke_batch"] if smoke else rcfg["batch"])
  H = int(rcfg["smoke_horizon"] if smoke else rcfg["horizon"])
  nv = scene.model.nv

  states = batch_states(scene, q0, B, torch.Generator(device=dev).manual_seed(0))
  pd = torch.zeros((B, nv), dtype=q0.dtype, device=dev)
  pd[:, 6:] = q0[7:]
  tau = torch.zeros_like(pd)
  try:
    fused = gpu_step.make_step_batch_fused(scene)
    step, step_path = (lambda s: fused(s, tau, pd)), "K1"
  except gpu_step.FusedStepUnsupported:
    step, step_path = (lambda s: scene.step_batch(s, tau, pd)), "K2"

  def rollout(s):
    for _ in range(H):
      s = step(s)
    return s

  t0 = time.perf_counter()
  if step_path == "K1" and dev.type == "cuda":
    fused.kernel                                 # registers the generated source
  build_kernels(dev)
  with torch.inference_mode():
    out = rollout(states)
    sync(dev)
  compile_s = time.perf_counter() - t0
  # time with perturbed inputs, as the JAX example does
  wall_s = float("inf")
  with torch.inference_mode():
    for i in range(2):
      si = State(q=states.q + (i + 1) * 1e-7, u=states.u, t=states.t)
      sync(dev)
      t0 = time.perf_counter()
      out = rollout(si)
      sync(dev)
      wall_s = min(wall_s, time.perf_counter() - t0)

  heights = out.q[:, 2].cpu()
  result = {
      "batch": B,
      "horizon": H,
      "rollouts_per_s": B / wall_s,
      "steps_per_s": B * H / wall_s,
      "compile_s": compile_s,
      "standing_fraction": float((heights > 0.9).float().mean()),
      "mean_height": float(heights.mean()),
      "n_devices": torch.cuda.device_count() if dev.type == "cuda" else 1,
      "physics_steps": 3 * H,
      "step_path": step_path,
      "device": str(dev),
  }
  metrics.emit("example_atlas_batch", path=metrics_path, echo=True, **result)
  if not smoke:
    gate(result["standing_fraction"] > 0.99, "robots fell in the batched scene")
  return result


if __name__ == "__main__":
  ap = cli(__doc__.splitlines()[0])
  ap.add_argument("--scaling", action="store_true",
                  help="the weak-scaling table (not ported yet: ROADMAP.md item 15)")
  args = ap.parse_args()
  run(smoke=args.smoke, scaling=args.scaling, device=args.device)
