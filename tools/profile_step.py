"""Where one batched ANYmal step spends its time on the card.

Run from the repository root on a machine with a CUDA device:

    python3 tools/profile_step.py [--batch 16384] [--steps 3]

It traces `--steps` warm steps of `Scene.step_batch` with torch.profiler and
prints: wall time per step (synchronised host clock), the summed device time
of all kernels per step, the device's idle share (1 - device time / wall
time), the number of kernel launches per step, and the kernels that take the
most device time. Kernels that overlap would count twice in the device sum;
this step runs on one stream, so they do not.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
  import torch
  from torch.profiler import ProfilerActivity, profile

  import chip_smoke

  ap = argparse.ArgumentParser()
  ap.add_argument("--batch", type=int, default=16384)
  ap.add_argument("--steps", type=int, default=3)
  args = ap.parse_args()
  if not torch.cuda.is_available():
    sys.exit("profile_step.py needs a CUDA device")

  scene = chip_smoke.anymal_scene(torch)
  with torch.inference_mode():
    s, pd, _ = chip_smoke.standing_states(torch, scene, args.batch, seed=2)
    for _ in range(2):                                  # warm-up, kernel build
      s = scene.step_batch(s, pd_target=pd)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
      t0 = time.perf_counter()
      for _ in range(args.steps):
        s = scene.step_batch(s, pd_target=pd)
      torch.cuda.synchronize()
      wall = (time.perf_counter() - t0) / args.steps
  events = prof.key_averages()
  dev = [e for e in events if getattr(e, "device_time_total", 0) > 0
         and e.device_type == torch.autograd.DeviceType.CUDA]
  dev_us = sum(e.device_time_total for e in dev) / args.steps
  launches = sum(e.count for e in events if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                                        "cudaLaunchKernelExC")) / args.steps
  print(f"batch {args.batch}: wall {1e3 * wall:.3f} ms/step, device {dev_us / 1e3:.3f} ms/step, "
        f"idle share {1.0 - dev_us / 1e6 / wall:.3f}, kernel launches {launches:.0f}/step")
  for e in sorted(dev, key=lambda e: -e.device_time_total)[:12]:
    print(f"  {e.device_time_total / args.steps / 1e3:9.3f} ms  x{e.count // args.steps:5d}  {e.key[:90]}")
  print(torch.cuda.get_device_name(0))


if __name__ == "__main__":
  main()
