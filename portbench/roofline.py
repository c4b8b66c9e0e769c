"""The yardstick of the fused step kernel (K1): its operations and bytes for
a batch, and the published peaks of the card they are held to.

The arithmetic is the system's `fused_step_cost`, frozen here together with
the operation and height-load counts in each configuration file, so that a
change to the kernel's emitter cannot move the yardstick. Peaks: one NVIDIA
H100 SXM (NVIDIA's data sheet), float32 outside the tensor cores, at the
full 700 W power limit.
"""

from __future__ import annotations

PEAK_FLOPS = 67e12          # float32 FLOP/s, CUDA cores
PEAK_BYTES = 3.35e12        # HBM3 bytes/s
PEAK_POWER_W = 700.0


def k1_cost(yardstick: dict, B: int):
  """(operations, bytes) of one step of B worlds: each float32 input (q, u,
  tau and, with PD, the targets) read once and each output (q', u') written
  once, plus the heights each world's probes load; the operations per world
  times B."""
  nq, nv = yardstick["nq"], yardstick["nv"]
  n_in = nq + 2 * nv + (nv if yardstick["use_pd"] else 0)
  words = n_in + nq + nv + yardstick["height_loads_per_world"]
  return B * yardstick["ops_per_world"], 4 * B * words


def bound_s(ops: float, nbytes: float) -> float:
  """The least time the card could take: the larger of the two bounds."""
  return max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES)
