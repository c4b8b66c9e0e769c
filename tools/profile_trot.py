"""Where one tick of the trot MPPI (chip_smoke.py phase 15) spends its time.

Run from the repository root on a machine with a CUDA device:

    python3 tools/profile_trot.py [--ticks 3]

After one warm-up tick (which also builds the fused kernel), it traces
`--ticks` ticks of chip_smoke.run_trot (4 terrains x 96 samples, H = 16,
8 substeps, fused="require") with torch.profiler and prints: wall time per
tick (synchronised host clock), the summed device time of all kernels per
tick, the device's idle share, kernel launches and host synchronisations
per tick, the kernels that take the most device time, and the host
operations that take the most host time. The trace also holds the run's
set-up (scene, terrains), a few milliseconds of it. With `--sync-debug` it
then runs one more tick under torch.cuda.set_sync_debug_mode("warn") and
prints where the host synchronises with the card (file:line, count).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
  import torch
  from torch.profiler import ProfilerActivity, profile

  import chip_smoke
  from raisimlib_torch.ops import gpu_contact as gc
  from raisimlib_torch.ops import gpu_step as gs

  ap = argparse.ArgumentParser()
  ap.add_argument("--ticks", type=int, default=3)
  ap.add_argument("--sync-debug", action="store_true")
  args = ap.parse_args()
  if not torch.cuda.is_available():
    sys.exit("profile_trot.py needs a CUDA device")

  chip_smoke.run_trot(torch, 1, gc, gs)                 # warm-up, kernel build
  with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    t, counts, _, _ = chip_smoke.run_trot(torch, args.ticks, gc, gs)
  wall = t / args.ticks
  events = prof.key_averages()
  dev = [e for e in events if getattr(e, "device_time_total", 0) > 0
         and e.device_type == torch.autograd.DeviceType.CUDA]
  dev_us = sum(e.device_time_total for e in dev) / args.ticks
  count = lambda *keys: sum(e.count for e in events if e.key in keys) / args.ticks  # noqa: E731
  launches = count("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")
  syncs = count("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpyAsync")
  print(f"trot tick: wall {1e3 * wall:.3f} ms, device {dev_us / 1e3:.3f} ms, idle share "
        f"{1.0 - dev_us / 1e6 / wall:.3f}, kernel launches {launches:.0f}, fused-step "
        f"launches {counts[1] / args.ticks:.0f}, synchronising copies and syncs {syncs:.0f}")
  print("device time by kernel, per tick:")
  for e in sorted(dev, key=lambda e: -e.device_time_total)[:10]:
    print(f"  {e.device_time_total / args.ticks / 1e3:9.3f} ms  x{e.count / args.ticks:7.0f}  "
          f"{e.key[:80]}")
  host = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
  waits = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpyAsync")
  busy = sum(e.self_cpu_time_total for e in host if e.key not in waits) / args.ticks
  print(f"host busy (self time of host operations, waits excluded) {busy / 1e3:.3f} ms per tick")
  print("host time by operation (self), per tick:")
  for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:14]:
    print(f"  {e.self_cpu_time_total / args.ticks / 1e3:9.3f} ms  x{e.count / args.ticks:7.0f}  "
          f"{e.key[:80]}")
  if args.sync_debug:
    import collections
    import warnings

    with warnings.catch_warnings(record=True) as caught:
      warnings.simplefilter("always")
      torch.cuda.set_sync_debug_mode("warn")
      chip_smoke.run_trot(torch, 1, gc, gs)
      torch.cuda.set_sync_debug_mode("default")
    where = collections.Counter(f"{os.path.relpath(w.filename)}:{w.lineno}" for w in caught
                                if "synchroniz" in str(w.message))
    print("host synchronisations in one tick (file:line, count):")
    for loc, n in where.most_common(12):
      print(f"  {n:5d}  {loc}")
  print(torch.cuda.get_device_name(0))


if __name__ == "__main__":
  main()
