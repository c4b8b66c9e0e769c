"""The mean host time of one dynamics call (`dyn_b`: the state-vector
conversions and K1's wrapper for its substeps' launches), in us."""


def read(trace):
  recs = trace.spans.named("dyn_b")
  if not recs:
    return None
  return sum(r[2] - r[1] for r in recs) / len(recs) * 1e-3
