"""Where one ANYmal balance iLQR solve (chip_smoke.py phase 35) spends its time.

Run from the repository root on a machine with a CUDA device:

    python3 tools/profile_ilqr.py [--fd-order 2] [--sync-debug]

It builds the iLQR scene's fused kernel (mpc/balance_ilqr.py: ANYmal at dt =
0.01 s), solves bench.py::bench_anymal_ilqr's problem once as a warm-up (8
envs, H = 50, 8 iterations, kernel-FD, fd_eps 2e-2), times one solve with a
synchronised host clock, then traces one more with torch.profiler and
prints: the traced solve's wall time (the profiler slows the host), the
summed device time of all kernels, the device's idle share, kernel
launches, fused-step launches and host synchronisations; for each phase range of ilqr_batch (ilqr.rollout,
ilqr.dynamics_jacobians, ilqr.cost_derivatives, ilqr.riccati,
ilqr.line_search) its host time and the device time of its kernels; the kernels
that take the most device time and the host operations that take the most
host time. With `--sync-debug` it then solves once more under
torch.cuda.set_sync_debug_mode("warn") and prints where the host
synchronises with the card (file:line, count).
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

RANGES = ("ilqr.rollout", "ilqr.dynamics_jacobians", "ilqr.cost_derivatives", "ilqr.riccati",
          "ilqr.line_search")


def main():
  import torch
  from torch.profiler import ProfilerActivity, profile

  import chip_smoke
  from raisimlib_torch.models import anymal
  from raisimlib_torch.mpc import balance_ilqr as bi
  from raisimlib_torch.mpc.ilqr import ILQRConfig, ilqr_batch
  from raisimlib_torch.mpc.state_map import make_contact_dyn_batch
  from raisimlib_torch.ops import gpu_step as gs

  ap = argparse.ArgumentParser()
  ap.add_argument("--fd-order", type=int, default=2)
  ap.add_argument("--sync-debug", action="store_true")
  args = ap.parse_args()
  if not torch.cuda.is_available():
    sys.exit("profile_ilqr.py needs a CUDA device")

  scene = bi.balance_scene()
  q0 = anymal.standing_q()
  dyn_fast, _, _ = make_contact_dyn_batch(scene, bi.CONTROL_DT, 1, use_pd=True, fused="require")
  rc, fc, _ = bi.balance_costs(q0, device=scene.device)
  cfg = ILQRConfig(iters=chip_smoke.ILQR_ITERS, deriv="fd", fd_order=args.fd_order)

  def solve(seed):
    """One synchronised solve from mk(seed): (seconds, fused-step launches)."""
    x0s, U0s = chip_smoke.ilqr_starts(torch, q0, seed, scene.device)
    n0 = gs.make_step_batch_fused.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ilqr_batch(dyn_fast, None, rc, fc, x0s, U0s, cfg)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, gs.make_step_batch_fused.launches - n0

  solve(0)                                            # warm-up, kernel build
  untraced, n_k1 = solve(1)
  with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    wall, _ = solve(2)
  events = prof.key_averages()
  # kernels only (the phase ranges are host events)
  dev = [e for e in events if getattr(e, "device_time_total", 0) > 0
         and e.device_type == torch.autograd.DeviceType.CUDA and e.key not in RANGES]
  dev_us = sum(e.device_time_total for e in dev)
  count = lambda *keys: sum(e.count for e in events if e.key in keys)  # noqa: E731
  launches = count("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")
  syncs = count("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpyAsync")
  print(f"iLQR solve, fd_order {args.fd_order}: untraced {1e3 * untraced:.1f} ms ({n_k1} "
        f"fused-step launches); traced wall {1e3 * wall:.1f} ms, device {dev_us / 1e3:.1f} ms, "
        f"idle share {1.0 - dev_us / 1e6 / wall:.3f}, kernel launches {launches}, "
        f"synchronising copies and syncs {syncs}")
  print("phase ranges (host time inclusive; device time of the kernels launched inside):")
  for key in RANGES:
    rs = [e for e in events if e.key == key]
    print(f"  {key:26s} host {sum(e.cpu_time_total for e in rs) / 1e3:9.1f} ms  device "
          f"{sum(getattr(e, 'device_time_total', 0) for e in rs) / 1e3:9.1f} ms  "
          f"x{sum(e.count for e in rs)}")
  print("device time by kernel:")
  for e in sorted(dev, key=lambda e: -e.device_time_total)[:10]:
    print(f"  {e.device_time_total / 1e3:9.3f} ms  x{e.count:6d}  {e.key[:80]}")
  host = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU
          and e.key not in RANGES]
  print("host time by operation (self):")
  for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:16]:
    print(f"  {e.self_cpu_time_total / 1e3:9.3f} ms  x{e.count:6d}  {e.key[:80]}")
  if args.sync_debug:
    import collections
    import warnings

    with warnings.catch_warnings(record=True) as caught:
      warnings.simplefilter("always")
      torch.cuda.set_sync_debug_mode("warn")
      solve(3)
      torch.cuda.set_sync_debug_mode("default")
    where = collections.Counter(f"{os.path.relpath(w.filename)}:{w.lineno}" for w in caught
                                if "synchroniz" in str(w.message))
    print("host synchronisations in one solve (file:line, count):")
    for loc, n in where.most_common(12):
      print(f"  {n:5d}  {loc}")
  print(torch.cuda.get_device_name(0))


if __name__ == "__main__":
  main()
