"""K1's share of its roofline in the MPC cells: the bound of every step
launch of the sample rollouts and the plant over the device time of the
kernels launched in the dynamics spans."""

from portbench.layer_metrics._k1 import roofline_pct


def read(trace):
  return roofline_pct(trace, "dyn_b")
