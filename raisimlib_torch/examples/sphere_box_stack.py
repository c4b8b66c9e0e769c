"""BASELINE config 2: a sphere on a box on flat ground, the box kicked
sideways: the contact solver's correctness surface (4+ simultaneous
contacts, friction, stacking). Counterpart of examples/sphere_box_stack.py:
it asserts that the stack settles over 10 s and reports penetration and
drift.

One world, stepped as a batch of one through the fused step (K1b on the
card, one launch a step; its plain twin on the CPU).

Run:  python3 -m raisimlib_torch.examples.sphere_box_stack [--smoke] [--device cpu]
"""

from __future__ import annotations

import os
import time

import torch

from raisimlib_torch.examples import METRICS_DIR, build_kernels, cli, gate, sync


def run(smoke: bool = False, device=None,
        metrics_path: str = os.path.join(METRICS_DIR, "sphere_box_stack.jsonl")) -> dict:
  """Simulate the stack for the scenario's sim_seconds (smoke_seconds with
  `smoke`) and return the record. A full-size run asserts the scenario's
  four gates."""
  from raisimlib_torch import scenarios
  from raisimlib_torch._device import resolve_device
  from raisimlib_torch.ops import gpu_step
  from raisimlib_torch.utils import metrics

  dev = resolve_device(device)
  cfg = scenarios.load("sphere_box_stack")
  rcfg = cfg["run"]
  dt = float(cfg["world"]["dt"])
  world, _ = scenarios.build_world(cfg, dtype=torch.float32, device=dev)
  scene = world.compile()
  s = scene.init_state()
  # kick the BOX sideways: sliding friction stops a box, so the stack must
  # re-settle (a kicked sphere rolls at 5/7 v0 and rolls off the box: no
  # gate can hold without rolling resistance)
  u = s.u.clone()
  u[3] = rcfg["kick_m_s"]
  s = scene.init_state(q=s.q[None], u=u[None])

  seconds = rcfg["smoke_seconds"] if smoke else rcfg["sim_seconds"]
  n = int(seconds / dt)
  step = gpu_step.make_step_batch_fused(scene, use_pd=False)
  tau = torch.zeros_like(s.u)

  t0 = time.perf_counter()
  if dev.type == "cuda":
    step.kernel                                # registers the generated source
  build_kernels(dev)
  compile_s = time.perf_counter() - t0
  with torch.inference_mode():
    sync(dev)
    t0 = time.perf_counter()
    zs = []
    for _ in range(n):
      s = step(s, tau)
      zs.append(s.q[0, [2, 9]])                 # box z, sphere z
    zs = torch.stack(zs).cpu()
    sync(dev)
    wall_s = time.perf_counter() - t0
  q, u = s.q[0].cpu(), s.u[0].cpu()

  box_z, sph_z = zs[:, 0], zs[:, 1]
  result = {
      "sim_seconds": seconds,
      "wall_s": wall_s,
      "realtime_factor": seconds / wall_s,
      "box_z_final": float(box_z[-1]),
      "sphere_z_final": float(sph_z[-1]),
      "box_penetration_max": float(max(0.0, 0.15 - float(box_z.min()))),
      "sphere_drift_xy": float(torch.linalg.norm(q[7:9])),
      "settled_speed": float(u.abs().max()),
      "compile_s": compile_s,
      "physics_steps": n,
      "step_path": "K1",
      "device": str(dev),
  }
  metrics.emit("example_sphere_box_stack", path=metrics_path, echo=True, **result)
  if not smoke:
    g = rcfg["gates"]
    gate(abs(result["box_z_final"] - g["box_rest_z"]) < g["rest_tol"],
         "box not resting on ground")
    gate(abs(result["sphere_z_final"] - g["sphere_rest_z"]) < g["rest_tol"],
         "sphere not resting on box")
    gate(result["box_penetration_max"] < g["max_penetration"], "penetration grew")
    gate(result["settled_speed"] < g["settled_speed"], "stack did not settle")
  return result


if __name__ == "__main__":
  args = cli(__doc__.splitlines()[0]).parse_args()
  run(smoke=args.smoke, device=args.device)
