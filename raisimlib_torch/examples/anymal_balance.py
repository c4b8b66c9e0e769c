"""BASELINE config 3: ANYmal standing-balance MPC on flat ground, 12 contacts.

Counterpart of examples/anymal_balance.py. Receding-horizon MPPI through the
hard-contact step recovers from a lateral push that topples the passive
(PD-hold-only) robot. Reports recovery quality and MPC solves/s.

The sample population steps through make_contact_dyn_batch(fused="require"):
K1a on the card, one launch a physics step, its plain twin on the CPU. The
passive PD hold steps its one world through the same fused step (B = 1). The
costs are batched: (B, nx) states in, (B,) costs out.

Run:  python3 -m raisimlib_torch.examples.anymal_balance [--smoke] [--device cpu]
"""

from __future__ import annotations

import os
import time

import torch

from raisimlib_torch.examples import METRICS_DIR, build_kernels, cli, gate, sync


def balance_costs(cw: dict, z0: float, q_stand, control_dt: float):
  """Batched running and final costs (rc(X, A, t) -> (B,), fc(X) -> (B,)) of
  the balance task: height, orientation, base and joint velocities, posture
  and effort, weighted by the scenario's `run.cost`."""
  from raisimlib_torch.ops.spatial import quat_box_minus

  ident = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=q_stand.dtype, device=q_stand.device)

  def rc(X, A, t):
    q, v = X[:, :19], X[:, 19:]
    return (cw["height"] * (q[:, 2] - z0) ** 2
            + cw["orientation"] * torch.sum(quat_box_minus(q[:, 3:7], ident) ** 2, 1)
            + cw["base_vel"] * torch.sum(v[:, :6] ** 2, 1)
            + cw["joint_vel"] * torch.sum(v[:, 6:] ** 2, 1)
            + cw["posture"] * torch.sum((q[:, 7:] - q_stand) ** 2, 1)
            + cw["effort"] * torch.sum((A - q_stand) ** 2, 1)) * control_dt

  def fc(X):
    q, v = X[:, :19], X[:, 19:]
    return (200.0 * (q[:, 2] - z0) ** 2
            + 50.0 * torch.sum(quat_box_minus(q[:, 3:7], ident) ** 2, 1)
            + 5.0 * torch.sum(v[:, :6] ** 2, 1))

  return rc, fc


def run(smoke: bool = False, device=None,
        metrics_path: str = os.path.join(METRICS_DIR, "anymal_balance.jsonl")) -> dict:
  """The closed loop and the passive comparison at the scenario's sizes (its
  smoke sizes with `smoke`); returns the record. A full-size run asserts the
  differential gates: the push topples the passive robot, and MPC holds the
  height by a margin. The recovery trajectory goes beside the metrics
  file."""
  from raisimlib_torch import scenarios
  from raisimlib_torch._device import resolve_device
  from raisimlib_torch.mpc.mppi import MPPIConfig, mppi_step_batch
  from raisimlib_torch.mpc.state_map import make_contact_dyn_batch, state_to_vec
  from raisimlib_torch.ops import gpu_step
  from raisimlib_torch.utils import metrics, trajectory

  dev = resolve_device(device)
  cfg = scenarios.load("anymal_balance")
  cc, rcfg, cw = cfg["controller"], cfg["run"], cfg["run"]["cost"]
  dtype = torch.float32
  control_dt, substeps = float(cc["control_dt"]), int(cc["substeps"])
  if abs(float(cfg["world"]["dt"]) * substeps - control_dt) > 1e-12:
    raise ValueError("world.dt * controller.substeps must equal controller.control_dt")
  scene, info = scenarios.build_scene(cfg, dtype=dtype, device=dev)
  nq, nv = scene.model.nq, scene.model.nv

  q0 = torch.tensor(info["standing_q"]["anymal"], dtype=dtype, device=dev)
  q_stand = q0[7:]
  z0 = float(q0[2])
  dyn_b, nx, nu = make_contact_dyn_batch(scene, control_dt, substeps, use_pd=True,
                                         fused="require")
  rc, fc = balance_costs(cw, z0, q_stand, control_dt)

  H = int(cc["smoke_horizon"] if smoke else cc["horizon"])
  K = int(cc["smoke_samples"] if smoke else cc["samples"])
  n_ticks = int(rcfg["smoke_ticks"] if smoke else rcfg["ticks"])
  push = float(rcfg["push_m_s"])
  mcfg = MPPIConfig(n_samples=K, sigma=float(cc["sigma"]), temperature=float(cc["temperature"]))

  u0 = torch.zeros(nv, dtype=dtype, device=dev)
  u0[4] = push
  x0 = state_to_vec(scene.init_state(q=q0[None], u=u0[None]))       # (1, nx)
  U0 = q_stand.expand(1, H, nu).clone()

  def tick(x, U, gen):
    """One MPPI update, the first action applied, the plan shifted."""
    sol = mppi_step_batch(dyn_b, rc, fc, x, U, gen, mcfg)
    x2 = dyn_b(x, sol.U[:, 0], 0)
    return x2, torch.cat([sol.U[:, 1:], sol.U[:, -1:]], 1), sol.cost[0]

  # the passive comparison: the PD hold only, one world through the fused step
  hold_step = gpu_step.make_step_batch_fused(scene)
  hold = torch.zeros((1, nv), dtype=dtype, device=dev)
  hold[0, 6:] = q_stand

  t0 = time.perf_counter()
  if dev.type == "cuda":
    hold_step.kernel                           # the same source as dyn_b's kernel
  build_kernels(dev)
  with torch.inference_mode():
    tick(x0, U0, torch.Generator(device=dev).manual_seed(1))    # warm-up
    sync(dev)
  compile_s = time.perf_counter() - t0

  gen = torch.Generator(device=dev).manual_seed(0)
  xs, costs = [], []
  with torch.inference_mode():
    sync(dev)
    t0 = time.perf_counter()
    x, U = x0, U0
    for _ in range(n_ticks):
      x, U, cost = tick(x, U, gen)
      xs.append(x[0])
      costs.append(cost)
    xs, costs = torch.stack(xs), torch.stack(costs)
    sync(dev)
    wall_s = time.perf_counter() - t0

    s = scene.init_state(q=q0[None], u=u0[None])
    zero_tau = torch.zeros_like(hold)
    for _ in range(n_ticks * substeps):
      s = hold_step(s, zero_tau, hold)
  xs, costs = xs.cpu(), costs.cpu()
  zs = xs[:, 2]

  # the replayable recovery trajectory:
  # python3 -m raisimlib_torch.examples.replay metrics/torch/anymal_balance_traj.npz
  traj = trajectory.from_states(scene, xs[:, :nq], xs[:, nq:], dt=control_dt)
  trajectory.save(os.path.join(os.path.dirname(metrics_path), "anymal_balance_traj.npz"), traj)

  result = {
      "push_m_s": push,
      "final_height": float(xs[-1, 2]),
      "passive_final_height": float(s.q[0, 2]),
      "min_height": float(zs.min()),
      "final_cost": float(costs[-1]),
      "mpc_solves_per_s": n_ticks / wall_s,
      "compile_s": compile_s,
      "ticks": n_ticks,
      "samples": K,
      "horizon": H,
      "physics_steps": (n_ticks + 1) * (H + 1) * substeps + n_ticks * substeps,
      "step_path": "K1",
      "device": str(dev),
  }
  metrics.emit("example_anymal_balance", path=metrics_path, echo=True, **result)
  if not smoke:
    # a DIFFERENTIAL claim: the push topples the passive PD-hold robot, and
    # MPC holds the height anyway, by a margin
    gate(result["passive_final_height"] < 0.5 * z0,
         "push too weak: passive robot did not topple — the demo proves nothing")
    gate(result["final_height"] > 0.9 * z0, "MPC failed to hold height")
    gate(result["final_height"] - result["passive_final_height"] > 0.25 * z0,
         "MPC did not beat passive PD by the margin")
  return result


if __name__ == "__main__":
  args = cli(__doc__.splitlines()[0]).parse_args()
  run(smoke=args.smoke, device=args.device)
