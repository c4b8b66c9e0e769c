"""The share of the traced window in which no kernel or copy ran on the card."""


def read(trace):
  s = trace.summary
  return 100.0 * (1.0 - s.busy_s / s.window_s)
