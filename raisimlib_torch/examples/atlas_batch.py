"""BASELINE config 5: an Atlas-class humanoid, 1024 robots batched on one card.

Counterpart of the single-card part of examples/atlas_batch.py. One Atlas
(23 actuated dofs, 29 in all; 32 contact slots, the corners of the pelvis,
torso and feet boxes against the ground, and 23 joint-limit rows) is
compiled once, and the batch of B perturbed standing robots steps together
under the per-group PD hold. Atlas is in the fused step's class, so the
batch steps through make_step_batch_fused (K1a at nv = 29 on the card, one
launch a step; its plain twin on the CPU); where the fused step refuses the
scene it falls back to Scene.step_batch (the K2 path), and the record's
`step_path` says which ran.

`--scaling` adds the weak-scaling table of the JAX example: the scenario's
`scaling` block (per-rank batch and horizon, overridden by the
ATLAS_SCALING_PER_DEV and ATLAS_SCALING_H environment variables), the PD
hold through parallel.make_sharded_rollout on meshes of the listed sizes
that the world holds, one process per card (torch.distributed; a single
process forms a one-rank group of its own):

Run:  python3 -m raisimlib_torch.examples.atlas_batch [--smoke] [--device cpu] [--scaling]
      torchrun --nproc-per-node 4 -m raisimlib_torch.examples.atlas_batch --scaling
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

  dev = resolve_device(device)
  own_group = False
  if scaling:
    # join the process group first: under a launcher it picks this rank's card
    import torch.distributed as dist

    from raisimlib_torch import parallel

    own_group = not dist.is_initialized()
    dev = parallel.init_distributed(device=dev if dev.type == "cpu" else None)
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
  if scaling:
    result["scaling"] = scaling_table(scene, q0, cfg, smoke, dev, own_group)
  return result


def scaling_table(scene, q0, cfg, smoke: bool, dev, own_group: bool) -> list:
  """The weak-scaling rows of the PD hold over meshes of the scenario's
  `device_counts` that the world holds, each emitted as an
  "atlas_weak_scaling" record by rank 0. Leaves the process group again if
  `run` formed it (`own_group`)."""
  import torch.distributed as dist

  from raisimlib_torch import parallel
  from raisimlib_torch.utils import metrics

  scfg = cfg["scaling"]
  per_dev = int(os.environ.get("ATLAS_SCALING_PER_DEV",
                               scfg["smoke_per_device"] if smoke else scfg["per_device"]))
  Hs = int(os.environ.get("ATLAS_SCALING_H", scfg["smoke_horizon"] if smoke else scfg["horizon"]))
  try:
    nv = scene.model.nv
    pd1 = torch.zeros(nv, dtype=q0.dtype, device=dev)
    pd1[6:] = q0[7:]

    def build(mesh):
      Bs = per_dev * mesh.size
      sts = batch_states(scene, q0, Bs, torch.Generator(device=dev).manual_seed(1))
      pds = pd1.expand(Bs, Hs, nv)
      fn = parallel.make_sharded_rollout(scene, mesh, use_pd=True)
      sts, pds = parallel.shard_batch(mesh, (sts, pds))

      def roll(s, p):
        with torch.inference_mode():
          return fn(s, p)[0].q
      return roll, (sts, pds)

    counts = [n for n in scfg["device_counts"] if n <= dist.get_world_size()]
    rows = parallel.weak_scaling_report(build, per_dev, device_counts=counts,
                                        unit="rollouts/s")
    if dist.get_rank() == 0:
      for r in rows:
        metrics.emit("atlas_weak_scaling",
                     path=os.path.join(METRICS_DIR, "atlas_weak_scaling.jsonl"), echo=True, **r)
    return rows
  finally:
    if own_group:
      dist.destroy_process_group()


if __name__ == "__main__":
  ap = cli(__doc__.splitlines()[0])
  ap.add_argument("--scaling", action="store_true",
                  help="also the weak-scaling table over the world's ranks")
  args = ap.parse_args()
  run(smoke=args.smoke, scaling=args.scaling, device=args.device)
