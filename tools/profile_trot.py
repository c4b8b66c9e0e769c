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
set-up (scene, terrains), a few milliseconds of it.

From the same profile it reads the program's spans
(raisimlib_torch/utils/profiling.py, recorded while the profiler runs, on
its clock) and prints, per tick: each span's count, host time and self
time (less its child spans); the device time of the kernels by the
innermost span their launch was issued in (K1's under `k1.enqueue`); and
the device's idle time between the first span's start and the last one's
end, put down to the innermost span the host was in ("-" for none).

With `--sync-debug` it then runs one more tick under
torch.cuda.set_sync_debug_mode("warn") and prints where the host
synchronises with the card (file:line, count).
"""

import argparse
import bisect
import collections
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _ns(e):
  """(start, end) of a kineto event in ns (older torch gives us only)."""
  if hasattr(e, "start_ns"):
    return e.start_ns(), e.end_ns()
  s = int(e.start_us() * 1000)
  return s, s + int(e.duration_us() * 1000)


def _is_launch(e):
  """A CUDA runtime or driver call on the host (from its name where this
  torch's event has no activity type)."""
  if hasattr(e, "activity_type"):
    return e.activity_type() in ("cuda_runtime", "cuda_driver")
  return e.device_type() == torch.autograd.DeviceType.CPU and e.name().startswith("cu")


def _is_device_op(e):
  """A kernel, copy or fill on the card."""
  if hasattr(e, "activity_type"):
    return e.activity_type() in ("kernel", "gpu_memcpy", "gpu_memset")
  return e.device_type() != torch.autograd.DeviceType.CPU


def innermost(recs):
  """The program's spans as a step function of time: the sorted times at
  which a span opens or closes and, from each, the name of the innermost
  open span ("-" for none)."""
  ev = []
  for i, r in enumerate(recs):
    if r.end_ns is not None:
      ev += [(r.start_ns, 1, i), (r.end_ns, 0, i)]
  ev.sort()                                   # at one time, closes before opens
  times, names, stack = [], [], []
  for t, opens, i in ev:
    if opens:
      stack.append(i)
    elif stack[-1] == i:
      stack.pop()
    else:
      stack.remove(i)
    times.append(t)
    names.append(recs[stack[-1]].name if stack else "-")
  return times, names


def name_at(times, names, t):
  k = bisect.bisect_right(times, t) - 1
  return names[k] if k >= 0 else "-"


def split(times, names, a, b, into):
  """Add the interval (a, b) to `into`, piece by piece, under the innermost
  span of each piece."""
  k = bisect.bisect_right(times, a) - 1
  while a < b:
    end = times[k + 1] if k + 1 < len(times) else b
    into[names[k] if k >= 0 else "-"] += min(end, b) - a
    a, k = min(end, b), k + 1


def span_report(prof, recs, ticks):
  """Print the program's spans, the device time by launching span and the
  device's idle time by the span the host was in, per tick."""
  n, host, own = collections.Counter(), collections.Counter(), collections.Counter()
  for r in recs:
    if r.end_ns is not None:
      n[r.name] += 1
      host[r.name] += r.end_ns - r.start_ns
      own[r.name] += r.end_ns - r.start_ns
      if r.parent >= 0:
        own[recs[r.parent].name] -= r.end_ns - r.start_ns
  print("program spans, per tick: count, host ms, self ms")
  for name, t in host.most_common():
    print(f"  {n[name] / ticks:8.1f}  {t / ticks / 1e6:9.3f}  {own[name] / ticks / 1e6:9.3f}  "
          f"{name}")
  times, names = innermost(recs)
  launch, dev = {}, []
  for e in prof.profiler.kineto_results.events():
    if _is_launch(e):
      launch[e.correlation_id()] = _ns(e)[0]
    elif _is_device_op(e):
      dev.append(_ns(e) + (e.name(), e.correlation_id()))
  by_span = collections.Counter()
  k1 = collections.Counter()
  for s, e, name, corr in dev:
    if corr in launch:
      span = name_at(times, names, launch[corr])
      by_span[span] += e - s
      if "fused_step_kernel" in name:
        k1[span] += 1
  print("device time by the innermost span of the launch, per tick: ms, K1 launches")
  for span, t in by_span.most_common():
    print(f"  {t / ticks / 1e6:9.3f}  {k1[span] / ticks:7.1f}  {span}")
  w0, w1 = times[0], times[-1]
  idle, busy_to = collections.Counter(), w0
  for s, e, *_ in sorted(d for d in dev if d[1] > w0 and d[0] < w1):
    if s > busy_to:
      split(times, names, busy_to, s, idle)
    busy_to = max(busy_to, e)
  if busy_to < w1:
    split(times, names, busy_to, w1, idle)
  total = sum(idle.values())
  print(f"device idle {total / ticks / 1e6:.3f} ms a tick of {(w1 - w0) / ticks / 1e6:.3f}, "
        "by the innermost span the host was in: ms")
  for span, t in idle.most_common(12):
    print(f"  {t / ticks / 1e6:9.3f}  {span}")


def main():
  from torch.profiler import ProfilerActivity, profile

  import chip_smoke
  from raisimlib_torch.ops import gpu_contact as gc
  from raisimlib_torch.ops import gpu_step as gs
  from raisimlib_torch.utils import profiling

  ap = argparse.ArgumentParser()
  ap.add_argument("--ticks", type=int, default=3)
  ap.add_argument("--sync-debug", action="store_true")
  args = ap.parse_args()
  if not torch.cuda.is_available():
    sys.exit("profile_trot.py needs a CUDA device")

  chip_smoke.run_trot(torch, 1, gc, gs)                 # warm-up, kernel build
  profiling.reset()
  with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    t, counts, _, _ = chip_smoke.run_trot(torch, args.ticks, gc, gs)
  recs = profiling.records()
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
  span_report(prof, recs, args.ticks)
  if args.sync_debug:
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
