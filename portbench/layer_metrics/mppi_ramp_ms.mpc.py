"""The host's ramp into an MPPI update, in ms: the mean over `mppi.update`
spans of the time from the update's start to the start of the first
`k1.enqueue` inside it. The plant's synchronisation has just emptied the
card's queue, so the card idles through it until its first K1."""

from portbench.layer_metrics._program import records


def read(trace):
  recs = records()
  update = [-1] * len(recs)             # the mppi.update each span lies in
  ramp = {}
  for i, r in enumerate(recs):
    update[i] = i if r.name == "mppi.update" else update[r.parent] if r.parent >= 0 else -1
    u = update[i]
    if r.name == "k1.enqueue" and u >= 0 and u not in ramp:
      ramp[u] = r.start_ns - recs[u].start_ns
  if not ramp:
    return None
  return sum(ramp.values()) / len(ramp) * 1e-6
