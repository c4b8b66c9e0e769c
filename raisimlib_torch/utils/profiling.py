"""Tracing, timing and tuning helpers: the port's counterpart of
raisimlib_tpu/utils/profiling.py.

  * `span` marks a stretch of the program's host work (an MPPI update, a
    dynamics call, K1's wrapper and its launch). Off, it is one shared
    no-op. On, inside `tracing()` or whenever torch.profiler records, it
    keeps (name, start, end, parent, attributes) in memory, on the clock of
    torch.profiler's events, and under the profiler opens a range of its
    name, an operator event that the kernels launched inside it are tied
    to; `records()` returns what was kept and `reset()` drops it;
  * `trace` runs a call under torch.profiler, CPU and CUDA activities,
    after one warm-up call, and writes a Chrome trace into `logdir`;
  * `tune_sweeps` picks the smallest Gauss-Seidel sweep count of
    pipeline.StepConfig that meets a one-step velocity tolerance.

The spans the program opens, and what reads them:

  mppi.update [E, K, H]  mpc/mppi.py: one MPPI update
  mppi.noise             its noise colouring, sample 0, the samples, the state expand
  mppi.cost              each running or final cost call of a rollout
  mppi.weights           the weighted (or elite) average
  dyn.call [B, substeps] mpc/state_map.py: one batched dynamics call
  k1.step [B]            ops/gpu_step.py: FusedStep.__call__ (K1's wrapper)
  k1.enqueue [B, lanes, solve]  the ctypes launch of K1 alone (on the card): the
                         build's lanes a world, and "called" or "inlined" for
                         its cone solve (gpu_step.solve_called)
  ilqr.*                 mpc/ilqr.py: the phases of an iLQR iteration

portbench's layer metrics `mppi_ramp_ms.mpc`, `k1_wrapper_us.mpc` and
`k1_enqueue_us.mpc` read them, as does tools/profile_trot.py.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Any, Callable, NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler


def _sync() -> None:
  if torch.cuda.is_available() and torch.cuda.is_initialized():
    torch.cuda.synchronize()


class Record(NamedTuple):
  name: str
  start_ns: int              # torch.profiler's clock: Unix-epoch nanoseconds
  end_ns: Optional[int]      # None while the span is open
  parent: int                # index of the enclosing span in records(), -1 for none
  attrs: dict


class _Recorder:
  """The spans of this process, kept while tracing is on. Spans nest on one
  stack: record them from one thread at a time."""

  def __init__(self):
    self.on = False          # tracing() is active
    self.records = []        # [name, start_ns, end_ns, parent, attrs]
    self.stack = []          # indices of the open spans
    self.offset = 0          # Unix-epoch ns less perf_counter_ns


_REC = _Recorder()
_OFF = contextlib.nullcontext()
# The profiler's range of a span: an operator-scoped record function. A
# `record_function` range (a user annotation) would also be mirrored on the
# device's timeline as a span from its first kernel to its last, which a
# reader of the trace could take for device work.
_RANGE = torch._C._profiler._RecordFunctionFast


class _Span:
  __slots__ = ("name", "attrs", "idx", "rf")

  def __init__(self, name, attrs):
    self.name, self.attrs = name, attrs

  def __enter__(self):
    rec = _REC
    if not rec.stack:        # a new tree: take the epoch offset afresh
      rec.offset = time.time_ns() - time.perf_counter_ns()
    self.idx = len(rec.records)
    rec.records.append([self.name, time.perf_counter_ns() + rec.offset, None,
                        rec.stack[-1] if rec.stack else -1, self.attrs])
    rec.stack.append(self.idx)
    self.rf = None
    if _autograd_profiler._is_profiler_enabled:
      self.rf = _RANGE(self.name)
      self.rf.__enter__()

  def __exit__(self, *exc):
    if self.rf is not None:
      self.rf.__exit__(*exc)
    rec = _REC
    rec.records[self.idx][2] = time.perf_counter_ns() + rec.offset
    rec.stack.pop()


def span(name: str, **attrs):
  """A context manager around a stretch of host work. It records only while
  tracing is on (`tracing()`, or torch.profiler recording); otherwise it is
  one shared no-op."""
  if not (_REC.on or _autograd_profiler._is_profiler_enabled):
    return _OFF
  return _Span(name, attrs)


@contextlib.contextmanager
def tracing():
  """Record spans inside this block, with or without torch.profiler."""
  was, _REC.on = _REC.on, True
  try:
    yield
  finally:
    _REC.on = was


def records() -> list:
  """The spans recorded since the last reset(), in the order they opened."""
  return [Record(*r) for r in _REC.records]


def reset() -> None:
  """Drop the recorded spans."""
  if _REC.stack:
    raise RuntimeError(f"reset() inside {len(_REC.stack)} open span(s)")
  _REC.records.clear()


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
