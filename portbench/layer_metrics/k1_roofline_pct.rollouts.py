"""K1's share of its roofline in the rollout cells: the bound of the step
launches over the device time of the kernels launched in the step spans."""

from portbench.layer_metrics._k1 import roofline_pct


def read(trace):
  return roofline_pct(trace, "step")
