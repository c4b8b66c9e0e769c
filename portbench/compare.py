"""The numbers that decide `correct`, from the gaps between what the timed
path produced and what the reference computes from the same state.

A row is one world's state after one step (or one control step) that the
reference replays from the state the system was given. Its gap is the
largest absolute difference over its coordinates (q) or velocities (u).

Two numbers of each: `*_gap_p99`, the 99th percentile of the rows' gaps,
which a small fault spread over many rows moves; and `*_gap_max`, the
largest gap once at most `set_aside` rows are set aside, and only rows
whose activation margin lies under `margin`. A row's margin is the
reference's smallest |depth| over its contact slots and |q + u dt - limit|
over its joint-limit rows, in every step of its replay: where it sits
within float32 rounding of zero (ANYmal's feet at the exact stance, a foot
touching down), one computation activates the row and the other does not,
and the row's gap is as large as its impulse. Every other row counts, so a
fault confined to a rare branch (an engaged limit, a sliding contact, one
world) shows in `*_gap_max` however few rows it touches.
"""

from __future__ import annotations

import sys

import torch

SHOWN = 8


def _largest_kept(row, loose, n: int):
  """The largest of `row` once the `n` largest rows where `loose` holds
  are set aside; NaN where any row is not finite."""
  if not torch.isfinite(row).all():
    return float("nan")
  rest = row[~loose]
  spare = torch.sort(row[loose], descending=True).values[n:]
  kept = torch.cat([rest, spare])
  return float(kept.max()) if kept.numel() else 0.0


def gaps(dq, du, margin, limits: dict):
  """[(name, value, limit)] of q_gap_p99, u_gap_p99, q_gap_max and
  u_gap_max; `margin` (rows,) the reference's activation margin of each
  row. A NaN fails any limit."""
  loose = margin < limits["margin"]
  n = int(limits["set_aside"])
  out = []
  for key, d in (("q", dq), ("u", du)):
    row = d.abs().amax(1)
    p99 = float(torch.quantile(row, 0.99)) if torch.isfinite(row).all() else float("nan")
    top = torch.argsort(row, descending=True)[:SHOWN].tolist()
    sys.stderr.write(
        f"{key}_gap: rows {row.numel()}, {int(loose.sum())} with margin under "
        f"{limits['margin']!r}, largest (gap, margin) "
        f"{[(float(row[i]), float(margin[i])) for i in top]}\n")
    out.append((f"{key}_gap_p99", p99, limits[f"{key}_gap_p99"]))
    out.append((f"{key}_gap_max", _largest_kept(row, loose, n), limits[f"{key}_gap_max"]))
  return out
