"""The torque-parity gate against the frozen ANYmal balance golden.

tests/goldens/anymal_balance.npz holds 50 f64 reference steps from a settled
stance under a lateral push and sinusoidal knee targets (kp = 100, kd = 2).
The observable is the applied PD torque (tests/test_parity.py). The reference
step (`Scene.step`) holds 1e-3 N m on the torque and 1e-4 on q over the whole
window in f32.

The batched step's solve is the TPU kernel's algorithm (grid + two 5-point
refinements + parabolic fit), not the reference's grid + Newton. In this
window the two slip searches part at about step 19, where a contact branch
flips, and the JAX package's own kernel path shows the same deviation as the
port's (f32: 4.128 N m at the flip, 4.5e-3 on q; f64: 0.085 N m, 5.6e-4). So
the batched gate is two-part: the first BATCH_TIGHT_STEPS steps hold the
reference gate, and the whole window stays under the measured ceiling.
"""

from __future__ import annotations

import numpy as np

TORQUE_GATE = 1e-3        # N m, the reference step's gate
Q_GATE = 1e-4
BATCH_TIGHT_STEPS = 15    # before the kernel's slip search parts from Newton's
BATCH_TORQUE_CEILING = 5.0    # N m over the window (measured 4.128, f32)
BATCH_Q_CEILING = 1e-2        # (measured 4.5e-3, f32)


def applied_torques(qs, us, q0, tgts, kp, kd, limit=40.0):
  """tau[t] = clip(kp (tgt[t] - q_pre[t]), +-limit) - kd u_post[t]: the
  implicit-PD torque the step applies."""
  qs_pre = np.concatenate([np.asarray(q0)[None], np.asarray(qs)[:-1]], axis=0)
  p = np.clip(kp * (np.asarray(tgts)[:, 6:] - qs_pre[:, 7:]), -limit, limit)
  return p - kd * np.asarray(us)[:, 6:]


def pd_torques(qs, us, q0, u0, tgts, kp, kd):
  """The PD law at the state entering each step."""
  qs_pre = np.concatenate([np.asarray(q0)[None], np.asarray(qs)[:-1]], axis=0)
  us_pre = np.concatenate([np.asarray(u0)[None], np.asarray(us)[:-1]], axis=0)
  return kp * (np.asarray(tgts)[:, 6:] - qs_pre[:, 7:]) - kd * us_pre[:, 6:]


def golden_deviation(qs, us, g):
  """Per step: (max |d tau| over PD and applied torques, max |dq|)."""
  kp, kd = float(g["kp"]), float(g["kd"])
  qs, us = np.asarray(qs, np.float64), np.asarray(us, np.float64)
  d_pd = np.abs(pd_torques(qs, us, g["q0"], g["u0"], g["pd_targets"], kp, kd)
                - pd_torques(g["q"], g["u"], g["q0"], g["u0"], g["pd_targets"], kp, kd))
  d_app = np.abs(applied_torques(qs, us, g["q0"], g["pd_targets"], kp, kd)
                 - applied_torques(g["q"], g["u"], g["q0"], g["pd_targets"], kp, kd))
  return np.maximum(d_pd.max(1), d_app.max(1)), np.abs(qs - g["q"]).max(1)


def reference_gate_failures(qs, us, g):
  """Messages for every breach of the reference step's gate (empty = pass)."""
  dtau, dq = golden_deviation(qs, us, g)
  out = []
  if dtau.max() > TORQUE_GATE:
    out.append(f"max|dtau| = {dtau.max():.3e} > {TORQUE_GATE}")
  if dq.max() > Q_GATE:
    out.append(f"max|dq| = {dq.max():.3e} > {Q_GATE}")
  return out


def batch_gate_failures(qs, us, g):
  """Messages for every breach of the batched step's gate (empty = pass)."""
  dtau, dq = golden_deviation(qs, us, g)
  k = BATCH_TIGHT_STEPS
  out = []
  if dtau[:k].max() > TORQUE_GATE:
    out.append(f"first {k} steps: max|dtau| = {dtau[:k].max():.3e} > {TORQUE_GATE}")
  if dq[:k].max() > Q_GATE:
    out.append(f"first {k} steps: max|dq| = {dq[:k].max():.3e} > {Q_GATE}")
  if dtau.max() > BATCH_TORQUE_CEILING:
    out.append(f"max|dtau| = {dtau.max():.3e} > {BATCH_TORQUE_CEILING}")
  if dq.max() > BATCH_Q_CEILING:
    out.append(f"max|dq| = {dq.max():.3e} > {BATCH_Q_CEILING}")
  return out
