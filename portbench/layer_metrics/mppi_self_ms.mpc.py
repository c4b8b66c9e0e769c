"""The mean self time of an MPPI update on the host: its span less the
dynamics calls inside it (noise colouring, costs, the weighted average and
the launches they issue), in ms."""


def read(trace):
  self_ns = trace.spans.self_ns("mppi", "dyn_b")
  if not self_ns:
    return None
  return sum(self_ns) / len(self_ns) * 1e-6
