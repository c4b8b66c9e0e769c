"""The torque-parity gates against the frozen ANYmal goldens.

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

tests/goldens/anymal_trot_heightmap.npz holds 80 f64 reference steps of an
open-loop trot segment on a procedural heightfield (kp = 120, kd = 3): feet
lift off and touch down inside the window, so a float32 rounding can move a
touchdown by one step, and the JAX package's gate (tests/test_parity.py,
TestAnymalTrotHeightmap) is two-sided: >= 95% of applied-torque entries
within 1e-3 N m, none above 0.5 N m. The trot gate holds every step path.
The batched paths do not part from the reference in this window, unlike
the balance golden's: the port's K2 twin in float32 on the CPU stays within
1.8e-5 N m over all 80 steps, the reference step within 1.7e-5
(tools/trot_golden_gate.py).

tests/goldens/sphere_box_stack.npz holds 400 f64 reference steps (0.8 s) of
the sphere-box stack (a box on the ground, a sphere on the box), the box
kicked sideways at 0.3 m/s: it slides, sticks, and the stack settles. The
observable is q; the JAX package's gate (tests/test_parity.py,
TestSphereBoxStack) is max|dq| <= 1e-4 over the window and the resting
heights (box z 0.15, sphere z 0.42) within 2e-3 at its end. It holds every
step path, the batched ones included: on the CPU in float32 the K2 twin and
the fused step's body stay within 4.4e-7 of the golden over all 400 steps
(tools/stack_golden_gate.py), so the stack needs no two-part gate.

tests/goldens/atlas_settle.npz holds 50 f64 reference steps of Atlas
(BASELINE config 5) settling under its per-group PD hold (kp 8000 on the
legs, 4000 on the back, 400 on the arms; dt = 4 ms). Its torques are
O(100) N m, so the JAX package's gate (tests/test_parity.py,
TestAtlasSettle) is relative to the 300 N m actuator limit: max |applied
torque difference| <= 1e-3 x 300 N m, and the base position within 2e-3 m
of the golden's at every step.
"""

from __future__ import annotations

import numpy as np

TORQUE_GATE = 1e-3        # N m, the reference step's gate
Q_GATE = 1e-4
BATCH_TIGHT_STEPS = 15    # before the kernel's slip search parts from Newton's
BATCH_TORQUE_CEILING = 5.0    # N m over the window (measured 4.128, f32)
BATCH_Q_CEILING = 1e-2        # (measured 4.5e-3, f32)
TROT_TIGHT_FRACTION = 0.95    # of applied-torque entries within TORQUE_GATE
TROT_TORQUE_CEILING = 0.5     # N m, 1.25% of the 40 N m actuator limit


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


def trot_deviation(qs, us, g):
  """|applied torque - the golden's| (T, 12) over the first T = len(qs)
  steps of the trot golden."""
  T = len(qs)
  kp, kd, lim = float(g["kp"]), float(g["kd"]), float(g["torque_limit"])
  tgts = np.asarray(g["pd_targets"])[:T]
  ours = applied_torques(np.asarray(qs, np.float64), np.asarray(us, np.float64),
                         g["q0"], tgts, kp, kd, lim)
  ref = applied_torques(np.asarray(g["q"])[:T], np.asarray(g["u"])[:T], g["q0"], tgts,
                        kp, kd, lim)
  return np.abs(ours - ref)


def trot_gate_failures(qs, us, g):
  """Messages for every breach of the trot gate (empty = pass)."""
  d = trot_deviation(qs, us, g)
  frac = float((d <= TORQUE_GATE).mean())
  out = []
  if frac < TROT_TIGHT_FRACTION:
    out.append(f"only {frac:.1%} of applied-torque entries within {TORQUE_GATE} N m")
  if d.max() > TROT_TORQUE_CEILING:
    out.append(f"max|dtau| = {d.max():.3e} > {TROT_TORQUE_CEILING} N m")
  return out


STACK_REST = (0.15, 0.42)     # m: box z (q[2]) and sphere z (q[9]) at rest
STACK_REST_TOL = 2e-3


def stack_deviation(qs, g):
  """Per step max |dq| against the stack golden, over the first len(qs)
  steps."""
  qs = np.asarray(qs, np.float64)
  return np.abs(qs - np.asarray(g["q"])[:len(qs)]).max(1)


def stack_gate_failures(qs, g):
  """Messages for every breach of the stack gate (empty = pass); the resting
  heights are checked when qs covers the whole window."""
  dq = stack_deviation(qs, g)
  out = []
  if dq.max() > Q_GATE:
    out.append(f"max|dq| = {dq.max():.3e} > {Q_GATE} (step {int(dq.argmax())})")
  if len(qs) == len(g["q"]):
    for name, k, z in (("box", 2, STACK_REST[0]), ("sphere", 9, STACK_REST[1])):
      if abs(float(qs[-1][k]) - z) >= STACK_REST_TOL:
        out.append(f"{name} rests at z = {float(qs[-1][k]):.5f}, not {z} +- {STACK_REST_TOL}")
  return out


ATLAS_TORQUE_REL = 1e-3       # of the actuator limit (the golden's torque_limit)
ATLAS_BASE_GATE = 2e-3        # m, base position


def atlas_deviation(qs, us, g):
  """Per step: (max |applied torque - the golden's| (N m), max |base
  position - the golden's| (m)), over the first len(qs) steps of the Atlas
  golden, with its per-dof gains."""
  T = len(qs)
  kp, kd = np.asarray(g["kp"])[6:], np.asarray(g["kd"])[6:]
  lim = float(g["torque_limit"])
  tgts = np.asarray(g["pd_targets"])[:T]
  qs, us = np.asarray(qs, np.float64), np.asarray(us, np.float64)
  ours = applied_torques(qs, us, g["q0"], tgts, kp, kd, lim)
  ref = applied_torques(np.asarray(g["q"])[:T], np.asarray(g["u"])[:T], g["q0"], tgts, kp, kd,
                        lim)
  return np.abs(ours - ref).max(1), np.abs(qs[:, :3] - np.asarray(g["q"])[:T, :3]).max(1)


def atlas_gate_failures(qs, us, g):
  """Messages for every breach of the Atlas gate (empty = pass)."""
  dtau, dbase = atlas_deviation(qs, us, g)
  gate = ATLAS_TORQUE_REL * float(g["torque_limit"])
  out = []
  if dtau.max() > gate:
    out.append(f"max|dtau| = {dtau.max():.3e} > {gate} N m (step {int(dtau.argmax())})")
  if dbase.max() > ATLAS_BASE_GATE:
    out.append(f"max|d base| = {dbase.max():.3e} > {ATLAS_BASE_GATE} m "
               f"(step {int(dbase.argmax())})")
  return out
