"""K1's launch on the host, in us: the mean duration of the `k1.enqueue`
spans (the ctypes call that enqueues one K1). A few us is a free launch
queue; hundreds say the host blocks on a full one."""

from portbench.layer_metrics._program import duration_ns, records


def read(trace):
  d = [duration_ns(r) for r in records() if r.name == "k1.enqueue" and r.end_ns is not None]
  return sum(d) / len(d) * 1e-3 if d else None
