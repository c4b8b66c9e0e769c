"""Timing and tracing helpers: the port's counterpart of
raisimlib_tpu/utils/profiling.py.

  * `time_call` times a callable with the first call (builds, caches) apart
    and the card synchronised before every clock read (the JAX package's
    `time_jitted`: a PyTorch call has nothing to jit);
  * `trace` runs a call under torch.profiler, CPU and CUDA activities,
    after one warm-up call, and writes a Chrome trace into `logdir`;
  * `tune_sweeps` picks the smallest Gauss-Seidel sweep count of
    pipeline.StepConfig that meets a one-step velocity tolerance.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable

import torch


def _sync() -> None:
  if torch.cuda.is_available() and torch.cuda.is_initialized():
    torch.cuda.synchronize()


def time_call(fn: Callable, *args, iters: int = 3, **kwargs) -> dict:
  """Time `fn(*args)`: {first_s, best_s, mean_s, runs}. The first call is
  timed apart (kernel builds, caches); use the BEST of `iters` runs for
  throughput claims."""
  t0 = time.perf_counter()
  fn(*args, **kwargs)
  _sync()
  first_s = time.perf_counter() - t0
  runs = []
  for _ in range(iters):
    t0 = time.perf_counter()
    fn(*args, **kwargs)
    _sync()
    runs.append(time.perf_counter() - t0)
  return {"first_s": first_s, "best_s": min(runs), "mean_s": sum(runs) / len(runs),
          "runs": runs}


def trace(fn: Callable, *args, logdir: str = "raisimlib_torch_trace", **kwargs) -> Any:
  """Run `fn(*args)` under torch.profiler after one warm-up call; the
  Chrome trace goes to `logdir`/trace.json (view it in Perfetto or
  chrome://tracing). Returns fn's result; the profile, whose
  key_averages() name the kernels, is `trace.last`."""
  from torch.profiler import ProfilerActivity, profile

  fn(*args, **kwargs)
  _sync()
  acts = [ProfilerActivity.CPU]
  if torch.cuda.is_available():
    acts.append(ProfilerActivity.CUDA)
  with profile(activities=acts) as prof:
    out = fn(*args, **kwargs)
    _sync()
  os.makedirs(logdir, exist_ok=True)
  prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
  trace.last = prof
  return out


trace.last = None


def tune_sweeps(scene, states, tau, pd_target=None, tol: float = 1e-4,
                candidates=(4, 6, 8, 12, 24), ref_sweeps: int = 48):
  """Smallest Gauss-Seidel sweep count meeting `tol` on THIS scene.

  The one-step velocity error of each candidate sweep count against a
  `ref_sweeps` reference, on the caller's probe `states` (a batched State
  covering the contact regimes of interest: resting, impacting, slipping),
  through pipeline.step_batch (K2 on the card). Returns `(sweeps, max_err)`
  for the smallest candidate with max|u' - u'_ref| <= tol, else the
  largest candidate and its error. One-step error is the metric: over a
  rollout, chaotic divergence amplifies any solver tolerance."""
  from raisimlib_torch.ops import pipeline

  def step_at(sweeps):
    cfg = pipeline.StepConfig()
    cfg = dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver, sweeps=sweeps))
    with torch.no_grad():
      return pipeline.step_batch(scene, states, tau, pd_target, cfg)

  ref = step_at(ref_sweeps)
  best = (candidates[-1], float("nan"))
  for sw in sorted(candidates):
    err = float((step_at(sw).u - ref.u).abs().max())
    if err <= tol:
      return sw, err
    best = (sw, err)
  return best
