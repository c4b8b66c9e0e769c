"""K1's wrapper on the host, in us: the median over `k1.step` spans of
their duration less their `k1.enqueue` child (heights, `_FusedFn`, the
launch's checks, `contiguous`, allocations, `t + dt`). Steps without a
launch (the CPU twin) are not counted."""

import statistics

from portbench.layer_metrics._program import duration_ns, records


def read(trace):
  recs = records()
  launch = {}
  for r in recs:
    if r.name == "k1.enqueue" and r.end_ns is not None and r.parent >= 0:
      launch[r.parent] = launch.get(r.parent, 0) + duration_ns(r)
  own = [duration_ns(r) - launch[i] for i, r in enumerate(recs)
         if r.name == "k1.step" and r.end_ns is not None and i in launch]
  return statistics.median(own) * 1e-3 if own else None
