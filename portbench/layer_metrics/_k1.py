"""Shared arithmetic of the K1 roofline readers."""

from portbench.roofline import bound_s, k1_cost


def roofline_pct(trace, span: str):
  """The roofline bound of every K1 launch issued inside `span` spans over
  the device time of all kernels launched there (whatever their names), in
  %; None where the window holds no such span or no linked kernel."""
  recs = trace.spans.named(span)
  dev_s = trace.summary.span_device_s.get(span, 0.0)
  if not recs or dev_s <= 0.0:
    return None
  bound = 0.0
  for r in recs:
    ops, nbytes = k1_cost(trace.yardstick, r[4]["B"])
    bound += r[4]["launches"] * bound_s(ops, nbytes)
  return 100.0 * bound / dev_s
