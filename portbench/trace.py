"""Spans from the benchmark's own calls into the system, and the reduction of
a torch.profiler trace to what the per-layer metrics read.

A span is opened around each call into a layer (an MPPI update, a dynamics
call, a rollout step, the harness's own input draws). Spans are kept in
memory, and only in a traced run: there each also opens a
`torch.profiler.record_function` range of its name, which ties the kernels
launched inside it to it. No trace file is written.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch

_DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_KINDS = ("cuda_runtime", "cuda_driver")


def _ns(e):
  """(start, end) of a kineto event in ns (older torch gives us only)."""
  if hasattr(e, "start_ns"):
    return e.start_ns(), e.end_ns()
  s = int(e.start_us() * 1000)
  return s, s + int(e.duration_us() * 1000)


def _kind(e, span_names) -> str:
  """The event's activity kind; from its device and name where this torch's
  KinetoEvent does not say (a host span carries one of the harness's span
  names, a runtime or driver call a cu-/cuda- name)."""
  if hasattr(e, "activity_type"):
    return e.activity_type()
  name = e.name()
  if e.device_type() != torch.autograd.DeviceType.CPU:
    return "gpu_user_annotation" if name in span_names else "kernel"
  if name in span_names:
    return "user_annotation"
  return "cuda_runtime" if name.startswith("cu") else "cpu_op"

class Spans:
  """Host spans (name, start_ns, end_ns, parent index, attributes), recorded
  while `on`; a no-op otherwise."""

  def __init__(self):
    self.on = False
    self.records = []
    self._stack = []
    self.marks = []

  def mark(self, name: str):
    """Note the end of a step of set-up (always, traced or not)."""
    self.marks.append((name, time.perf_counter()))

  @contextlib.contextmanager
  def _span(self, name, attrs):
    rf = torch.profiler.record_function(name)
    rf.__enter__()
    idx = len(self.records)
    self.records.append([name, time.perf_counter_ns(), None,
                         self._stack[-1] if self._stack else -1, attrs])
    self._stack.append(idx)
    try:
      yield
    finally:
      self._stack.pop()
      self.records[idx][2] = time.perf_counter_ns()
      rf.__exit__(None, None, None)

  def __call__(self, name: str, **attrs):
    return self._span(name, attrs) if self.on else contextlib.nullcontext()

  def named(self, name: str):
    return [r for r in self.records if r[0] == name and r[2] is not None]

  def self_ns(self, name: str, child: str):
    """Each `name` span's duration less that of its `child` spans."""
    kids = defaultdict(int)
    for r in self.records:
      if r[0] == child and r[3] >= 0:
        kids[r[3]] += r[2] - r[1]
    return [r[2] - r[1] - kids[i] for i, r in enumerate(self.records)
            if r[0] == name and r[2] is not None]


def _innermost(intervals, points):
  """For each point, the name of the innermost interval (start, end, name)
  that holds it ("" for none); the intervals nest."""
  ev = []
  for s, e, name in intervals:
    ev.append((s, 0, name))
    ev.append((e, 2, name))
  for k, t in enumerate(points):
    ev.append((t, 1, k))
  ev.sort(key=lambda x: (x[0], x[1]))
  out = [""] * len(points)
  stack = []
  for _, kind, x in ev:
    if kind == 0:
      stack.append(x)
    elif kind == 2:
      if x in stack:
        del stack[len(stack) - 1 - stack[::-1].index(x)]
    else:
      out[x] = stack[-1] if stack else ""
  return out


class Summary:
  """What a traced window holds: the device's busy time, the device time of
  the kernels launched inside each span name, the busiest device operations
  and the idle gaps named by the span the host was in."""

  def __init__(self, prof, span_names, window_name: str = "window"):
    evs = prof.profiler.kineto_results.events()
    host, launch, dev = [], {}, []
    self.kinds = defaultdict(int)
    for e in evs:
      kind = _kind(e, span_names)
      self.kinds[kind] += 1
      if kind == "user_annotation" and e.name() in span_names:
        host.append(_ns(e) + (e.name(),))
      elif kind in _LAUNCH_KINDS:
        launch[e.correlation_id()] = _ns(e)[0]
      elif kind in _DEVICE_KINDS:
        dev.append(_ns(e) + (e.name(), e.correlation_id(), kind))
    win = [h for h in host if h[2] == window_name]
    if len(win) != 1 or not dev:
      raise RuntimeError(f"the trace holds {len(win)} windows and {len(dev)} device "
                         "operations: the profiler saw no device work")
    w0, w1 = win[0][0], win[0][1]
    self.window_s = (w1 - w0) * 1e-9
    dev = [d for d in dev if d[1] > w0 and d[0] < w1]
    self.n_device_ops = len(dev)

    # kernels by the span their launch was issued in
    spans = [h for h in host if h[2] != window_name]
    linked = [d for d in dev if d[3] in launch]
    self.n_linked = len(linked)
    owner = _innermost(spans, [launch[d[3]] for d in linked])
    self.span_device_s = defaultdict(float)
    for d, name in zip(linked, owner):
      self.span_device_s[name] += (d[1] - d[0]) * 1e-9

    by_name = defaultdict(float)
    for d in dev:
      by_name[d[2][:160]] += (d[1] - d[0]) * 1e-9
    self.device_ops = sorted(by_name.items(), key=lambda x: -x[1])[:10]

    # busy time: the union of the device intervals inside the window
    busy, gaps = 0, []
    cur_s, cur_e = None, None
    for s, e, *_ in sorted((max(d[0], w0), min(d[1], w1)) for d in dev):
      if cur_e is None or s > cur_e:
        if cur_e is not None:
          busy += cur_e - cur_s
          gaps.append((cur_e, s))
        elif s > w0:
          gaps.append((w0, s))
        cur_s, cur_e = s, e
      else:
        cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    if cur_e < w1:
      gaps.append((cur_e, w1))
    self.busy_s = busy * 1e-9
    names = _innermost(spans, [(a + b) // 2 for a, b in gaps])
    idle = defaultdict(float)
    for (a, b), name in zip(gaps, names):
      idle[name or "harness"] += (b - a) * 1e-9
    self.idle_gaps = sorted(idle.items(), key=lambda x: -x[1])[:10]

