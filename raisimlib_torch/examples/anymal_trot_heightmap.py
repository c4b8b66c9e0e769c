"""BASELINE config 4: ANYmal trotting MPC over procedural heightmaps, a batch
of terrains in one controller.

Counterpart of examples/anymal_trot_heightmap.py. Receding-horizon MPPI
around a diagonal-pair trot reference (LF+RH and RF+LH at opposite phase)
optimises PD-target sequences through the hard-contact step, every terrain
in one batch: its (terrains x samples) population steps through
make_contact_dyn_batch(fused="require") with each row's terrain heights
(K1c on the card, one launch a physics step; its plain twin on the CPU).
The terrains come from utils/terrain.generate with a torch.Generator seeded
11, the controller's noise from one seeded 7.

Run:  python3 -m raisimlib_torch.examples.anymal_trot_heightmap [--smoke] [--device cpu]
"""

from __future__ import annotations

import math
import os
import time

import torch

from raisimlib_torch.examples import METRICS_DIR, build_kernels, cli, gate, sync


def gait_reference(n: int, control_dt: float, freq: float = 1.5, swing: float = 0.22,
                   dtype=torch.float32, device=None):
  """(n, 12) PD-target table: the stance plus trot flexion on the swing pair
  (legs LF RF LH RH; LF+RH at phase 0, RF+LH at pi; hind legs mirrored)."""
  from raisimlib_torch._device import resolve_device
  from raisimlib_torch.models import anymal

  dev = resolve_device(device)
  q_stand = torch.as_tensor(anymal.standing_q(), dtype=dtype, device=dev)[7:]
  t = torch.arange(n, dtype=dtype, device=dev) * control_dt
  phase = 2.0 * math.pi * freq * t                                  # (n,)
  offsets = torch.tensor([0.0, math.pi, math.pi, 0.0], dtype=dtype, device=dev)
  mirror = torch.tensor([1.0, 1.0, -1.0, -1.0], dtype=dtype, device=dev)
  sw = torch.clamp(torch.sin(phase[:, None] + offsets[None, :]), min=0.0)   # (n, 4)
  tgt = q_stand[None].repeat(n, 1).reshape(n, 4, 3)
  tgt[:, :, 1] += swing * sw * mirror[None, :]                      # HFE flex
  tgt[:, :, 2] += -1.6 * swing * sw * mirror[None, :]               # KFE fold
  return tgt.reshape(n, 12)


def trot_costs(field0, z0: float, v_target: float, control_dt: float):
  """Batched running and final costs of the trot, each row on its own
  terrain: rc(X, A, t, heights) -> (B,), fc(X, heights) -> (B,), heights
  (B, nx, ny). Forward speed toward v_target, height over the terrain,
  orientation, lateral and vertical speed, joint speeds."""
  from raisimlib_torch.ops import heightmap as hm
  from raisimlib_torch.ops.spatial import quat_box_minus

  ident = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=field0.heights.dtype,
                       device=field0.heights.device)

  def rc(X, A, t, heights):
    q, v = X[:, :19], X[:, 19:]
    z_surf, _, _ = hm.surface_at(field0.replace(heights=heights), q[:, :2])
    return (9.0 * (v[:, 3] - v_target) ** 2                        # forward speed
            + 30.0 * (q[:, 2] - z_surf - z0) ** 2                   # height over terrain
            + 8.0 * torch.sum(quat_box_minus(q[:, 3:7], ident) ** 2, 1)
            + 0.3 * (v[:, 4] ** 2 + v[:, 5] ** 2)                   # lateral, vertical
            + 0.02 * torch.sum(v[:, 6:] ** 2, 1)) * control_dt

  def fc(X, heights):
    q = X[:, :19]
    z_surf, _, _ = hm.surface_at(field0.replace(heights=heights), q[:, :2])
    return (100.0 * (q[:, 2] - z_surf - z0) ** 2
            + 30.0 * torch.sum(quat_box_minus(q[:, 3:7], ident) ** 2, 1))

  return rc, fc


def run(smoke: bool = False, device=None,
        metrics_path: str = os.path.join(METRICS_DIR, "anymal_trot.jsonl")) -> dict:
  """The closed-loop trot on every terrain at the scenario's sizes (its
  smoke sizes with `smoke`); returns the record. A full-size run asserts
  the gates: >= 3 s simulated, every robot >= 0.5 m forward, none below
  0.3 m. Terrain 0's trajectory goes beside the metrics file."""
  from raisimlib_torch import scenarios
  from raisimlib_torch._device import resolve_device
  from raisimlib_torch.mpc.mppi import MPPIConfig, mppi_step_batch
  from raisimlib_torch.mpc.state_map import make_contact_dyn_batch
  from raisimlib_torch.ops import heightmap as hm
  from raisimlib_torch.utils import metrics, terrain, trajectory

  dev = resolve_device(device)
  cfg = scenarios.load("anymal_trot_heightmap")
  cc, tc, rcfg, gc = cfg["controller"], cfg["terrain"], cfg["run"], cfg["gait"]
  dtype = torch.float32
  control_dt, substeps = float(cc["control_dt"]), int(cc["substeps"])
  if abs(float(cfg["world"]["dt"]) * substeps - control_dt) > 1e-12:
    raise ValueError("world.dt * controller.substeps must equal controller.control_dt")
  E = int(tc["smoke_n_terrains"] if smoke else tc["n_terrains"])
  n_ticks = int(rcfg["smoke_ticks"] if smoke else rcfg["ticks"])
  H = int(cc["smoke_horizon"] if smoke else cc["horizon"])
  K = int(cc["smoke_samples"] if smoke else cc["samples"])
  v_target = float(rcfg["v_target"])
  z_rough = float(tc["smoke_z_scale"] if smoke else tc["z_scale"])

  scene, info = scenarios.build_scene(cfg, dtype=dtype, device=dev)
  tsize, tsamples = tuple(info["terrain"]["size"]), tuple(info["terrain"]["samples"])
  nq = scene.model.nq
  q0 = torch.tensor(info["standing_q"]["anymal"], dtype=dtype, device=dev)
  z0 = float(q0[2])
  gait = gait_reference(n_ticks + H, control_dt, freq=float(gc["freq_hz"]),
                        swing=float(gc["swing"]), dtype=dtype, device=dev)
  mcfg = MPPIConfig(n_samples=K, sigma=float(cc["sigma"]), temperature=float(cc["temperature"]))
  field0 = scene.field
  rc, fc = trot_costs(field0, z0, v_target, control_dt)
  dyn_b, nx, nu = make_contact_dyn_batch(scene, control_dt, substeps, use_pd=True,
                                         fused="require")

  props = terrain.TerrainProperties(z_scale=z_rough, x_size=tsize[0], y_size=tsize[1],
                                    x_samples=tsamples[0], y_samples=tsamples[1])
  tgen = torch.Generator().manual_seed(11)
  heights = torch.stack([terrain.generate(props, tgen, dtype=dtype, device=dev).heights
                         for _ in range(E)])
  z_start, _, _ = hm.surface_at(field0.replace(heights=heights), q0[None, :2].expand(E, 2))
  x0 = torch.cat([q0[None].repeat(E, 1), torch.zeros((E, nx - nq), dtype=dtype, device=dev)], 1)
  x0[:, 2] += z_start

  def tick(xs, dUs, m, gen):
    """One MPPI update of every terrain's plan around the gait reference,
    the first action applied, the plan's offsets shifted."""
    base = gait[m:m + H]                                            # upcoming references
    sol = mppi_step_batch(dyn_b, rc, fc, xs, base[None] + dUs, gen, mcfg, env_ctx=heights)
    x2 = dyn_b(xs, sol.U[:, 0], 0, heights)
    dU2 = torch.cat([sol.U[:, 1:] - base[None, 1:], sol.U[:, -1:] - base[None, -1:]], 1)
    return x2, dU2

  dU0 = torch.zeros((E, H, nu), dtype=dtype, device=dev)
  t0 = time.perf_counter()
  build_kernels(dev)                               # dyn_b's kernel
  with torch.inference_mode():
    tick(x0, dU0, 0, torch.Generator(device=dev).manual_seed(1))    # warm-up
    sync(dev)
  compile_s = time.perf_counter() - t0

  gen = torch.Generator(device=dev).manual_seed(7)
  with torch.inference_mode():
    sync(dev)
    t0 = time.perf_counter()
    xs, dUs, hist = x0, dU0, []
    for m in range(n_ticks):
      xs, dUs = tick(xs, dUs, m, gen)
      hist.append(xs)
    hist = torch.stack(hist, 1)                      # (E, n_ticks, nx)
    sync(dev)
    wall_s = time.perf_counter() - t0
  xf, hist = xs.cpu(), hist.cpu()
  dist, zs = xf[:, 0], xf[:, 2]

  # the replayable trajectory of terrain 0's closed-loop trot:
  # python3 -m raisimlib_torch.examples.replay metrics/torch/anymal_trot_traj.npz
  traj = trajectory.from_states(scene, hist[0, :, :nq], hist[0, :, nq:], dt=control_dt)
  traj["terrain_heights"] = heights[0].cpu().numpy()
  trajectory.save(os.path.join(os.path.dirname(metrics_path), "anymal_trot_traj.npz"), traj)
  result = {
      "n_terrains": E,
      "ticks": n_ticks,
      "sim_seconds": n_ticks * control_dt,
      "mean_forward_m": float(dist.mean()),
      "min_forward_m": float(dist.min()),
      "final_heights": [round(float(z), 3) for z in zs],
      "mpc_solves_per_s": E * n_ticks / wall_s,
      "sample_rollouts_per_s": E * n_ticks * K / wall_s,
      "compile_s": compile_s,
      "terrain_z_scale": z_rough,
      "samples": K,
      "horizon": H,
      "physics_steps": (n_ticks + 1) * (H + 1) * substeps,
      "step_path": "K1",
      "device": str(dev),
  }
  metrics.emit("example_anymal_trot_heightmap", path=metrics_path, echo=True, **result)
  if not smoke:
    # a defensible gait bar: every robot covers >= 0.5 m over >= 3 s of
    # closed loop, trotting toward v_target rather than drifting
    gate(result["sim_seconds"] >= 3.0, "non-smoke run must simulate >= 3 s")
    gate(result["min_forward_m"] > 0.5, "a robot failed to trot forward")
    gate(bool((zs > 0.3).all()), "a robot fell")
  return result


if __name__ == "__main__":
  args = cli(__doc__.splitlines()[0]).parse_args()
  run(smoke=args.smoke, device=args.device)
