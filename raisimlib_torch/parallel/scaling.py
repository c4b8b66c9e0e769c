"""Weak-scaling harness: the port's counterpart of
raisimlib_tpu/parallel/scaling.py.

Times a sharded workload at a ladder of mesh sizes with a FIXED per-rank
batch (weak scaling: more ranks, more scenarios). Efficiency at n ranks is
the per-rank throughput relative to the smallest mesh; a 1 is prepended to
`device_counts` so that the baseline is one rank. A mesh of n ranks covers
the world's first n ranks; the others wait for the row to end. Every rank
gets the table back; callers emit it through utils/metrics.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from raisimlib_torch.parallel import mesh as mesh_lib


def _sync(device: torch.device) -> None:
  if device.type == "cuda":
    torch.cuda.synchronize(device)


def time_workload(build: Callable, n_devices: int, repeats: int = 3) -> float:
  """`build(mesh) -> (fn, args)`; the best wall-clock seconds of fn(*args)
  over `repeats` runs after one warm-up run, the card synced before each
  clock read, the slowest rank's time (one all_reduce a run), the same on
  every rank. Ranks outside the mesh of `n_devices` take part in the mesh's
  creation and the reductions only."""
  m = mesh_lib.make_mesh(n_devices)
  inside = m.contains()
  if inside:
    fn, args = build(m)
    fn(*args)                                       # warm-up: builds, caches
    _sync(m.device)
  best = float("inf")
  for _ in range(repeats):
    dist.barrier()
    t = torch.zeros((), dtype=torch.float64, device=mesh_lib.local_device())
    if inside:
      t0 = time.perf_counter()
      fn(*args)
      _sync(m.device)
      t.fill_(time.perf_counter() - t0)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    best = min(best, float(t))
  return best


def weak_scaling_report(build: Callable, items_per_device: int,
                        device_counts: Optional[Sequence[int]] = None, repeats: int = 3,
                        unit: str = "items/s") -> List[dict]:
  """Weak-scaling table. `build(mesh) -> (fn, args)` sizes its batch as
  `items_per_device * mesh.size`. Returns one record per mesh size:
  {n_devices, seconds, throughput, per_device, efficiency, unit}, the same
  on every rank."""
  n_avail = dist.get_world_size()
  if device_counts is None:
    device_counts = [n for n in (1, 2, 4, 8, 16, 32) if n <= n_avail]
  elif 1 not in device_counts:
    device_counts = [1] + sorted(device_counts)
  rows: List[dict] = []
  base_per_dev = None
  for n in device_counts:
    secs = time_workload(build, n, repeats)
    thr = items_per_device * n / secs
    per_dev = thr / n
    if base_per_dev is None:
      base_per_dev = per_dev
    rows.append({"n_devices": n, "seconds": secs, "throughput": thr, "per_device": per_dev,
                 "efficiency": per_dev / base_per_dev, "unit": unit})
  return rows
