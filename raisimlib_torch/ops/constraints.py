"""Constraint rows for the contact solver: joint limits, stiff wires, pins;
and compliant wires as forces.

Counterpart of raisimlib_tpu/ops/constraints.py. Every constraint is a
statically-shaped pseudo-contact row masked by an `active` flag, appended to
the same solver system as the real contacts. Row kinds:
  * "cone"      — frictional contact (mu from the material table)
  * "lin"       — frictionless unilateral row (joint limit, stiff wire): only
                  the 3rd ("normal") component is used
  * "bilateral" — equality row triplet (pin), flagged by the BILATERAL_MU
                  sentinel for the generic solver
Compliant wires are not solver rows: they are spring-damper forces that go
into the bias term through RNEA's external-force input (`compliant_forces`).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from raisimlib_torch.models.model import JointType
from raisimlib_torch.ops import dynamics
from raisimlib_torch.ops import spatial as sp

BILATERAL_MU = 1e6


class WireSpec(NamedTuple):
  """A stiff wire: body index (-1 = world), attach point in that body's
  frame (world coordinates for -1), for each end, and the rest length."""

  body_a: int
  pos_a: Tuple[float, float, float]
  body_b: int
  pos_b: Tuple[float, float, float]
  length: float


class PinSpec(NamedTuple):
  body_a: int
  pos_a: Tuple[float, float, float]
  body_b: int
  pos_b: Tuple[float, float, float]


class CompliantWireSpec(NamedTuple):
  body_a: int
  pos_a: Tuple[float, float, float]
  body_b: int
  pos_b: Tuple[float, float, float]
  length: float
  stiffness: float
  damping: float


class ConstraintTables(NamedTuple):
  """Frozen constraint description on a Scene (same fields as the JAX package)."""

  limit_vadr: Tuple[int, ...]
  limit_qadr: Tuple[int, ...]
  limit_lo: Tuple[float, ...]
  limit_hi: Tuple[float, ...]
  wires: tuple
  pins: tuple
  compliant: tuple

  @property
  def n_rows(self) -> int:
    return len(self.limit_vadr) + len(self.wires) + len(self.pins)

  @property
  def row_kinds(self) -> Tuple[str, ...]:
    return (("lin",) * (len(self.limit_vadr) + len(self.wires))
            + ("bilateral",) * len(self.pins))


EMPTY = ConstraintTables((), (), (), (), (), (), ())


def build_tables(model, joint_limits: bool, wires=(), pins=(),
                 compliant=()) -> ConstraintTables:
  """Limit rows for every dof with a finite URDF limit (1-dof joints
  only), and the given wires, pins and compliant wires (any NamedTuples of
  their fields, the JAX package's included)."""
  vadr, qadr, lo, hi = [], [], [], []
  if joint_limits:
    jlo = model.joint_lo.detach().cpu().double().numpy()
    jhi = model.joint_hi.detach().cpu().double().numpy()
    for j in range(model.nv):
      if jlo[j] > -1e8 or jhi[j] < 1e8:
        vadr.append(j)
        qadr.append(_dof_to_q(model, j))
        lo.append(float(jlo[j]))
        hi.append(float(jhi[j]))
  return ConstraintTables(tuple(vadr), tuple(qadr), tuple(lo), tuple(hi),
                          tuple(WireSpec(*w) for w in wires),
                          tuple(PinSpec(*p) for p in pins),
                          tuple(CompliantWireSpec(*c) for c in compliant))


def _dof_to_q(model, j: int) -> int:
  for i in range(model.nb):
    if JointType(model.joint_types[i]) in (JointType.FREE, JointType.SPHERICAL):
      continue
    if model.v_adr[i] == j:
      return model.q_adr[i]
  raise ValueError(f"dof {j} is not a 1-dof joint dof")


def _attach_world(kin, body: int, pos, like):
  """(B, 3) world position of the attach point `pos` of `body` (-1: pos is
  already in world coordinates)."""
  p = torch.as_tensor(pos, dtype=like.dtype, device=like.device)
  if body < 0:
    return p.expand(like.shape[0], 3)
  return kin.p[:, body] + sp._mv(kin.R[:, body], p)


def _point_jac(model, kin, body: int, pt_w):
  if body < 0:
    return torch.zeros((pt_w.shape[0], 3, model.nv), dtype=pt_w.dtype, device=pt_w.device)
  return dynamics.point_jacobian(model, kin, body, pt_w)


def constraint_rows(model, tables: ConstraintTables, kin, q, u, dt, erp: float,
                    max_corr: float):
  """(J (B,k,3,nv), bias (B,k,3), mu (B,k), active (B,k)) for the limit,
  wire and pin rows, in that order; `kin` is the FK of q (and u).

  Row frames are final (identity). A limit or wire row uses component 2
  only (0 and 1 are zero tangents), with the Baumgarte bias, matching the
  contact convention v_n+ >= b: a limit row's one-step lookahead engages it
  before impact; a wire row pulls A toward B along the wire and is active
  when the wire is taut now or by the end of the step. A pin row is the 3
  world axes of the anchor gap, a bilateral triplet (mu = 10 BILATERAL_MU)
  always active, its bias closing the gap."""
  k = len(tables.limit_vadr)
  B = q.shape[0]
  dtype, dev = q.dtype, q.device
  qi = torch.as_tensor(tables.limit_qadr, dtype=torch.long, device=dev)
  vi = torch.as_tensor(tables.limit_vadr, dtype=torch.long, device=dev)
  lo = torch.as_tensor(tables.limit_lo, dtype=dtype, device=dev)
  hi = torch.as_tensor(tables.limit_hi, dtype=dtype, device=dev)
  q_pred = q[:, qi] + u[:, vi] * dt                        # (B, k)
  near_hi = q_pred > hi
  near_lo = q_pred < lo
  s = torch.where(near_hi, -1.0, 1.0).to(dtype)
  viol = torch.maximum(lo - q_pred, q_pred - hi)
  b = torch.clamp(erp * torch.clamp(viol, min=0.0) / dt, 0.0, max_corr)
  onehot = torch.zeros((k, model.nv), dtype=dtype, device=dev)
  onehot[torch.arange(k, device=dev), vi] = 1.0
  J = torch.zeros((B, k, 3, model.nv), dtype=dtype, device=dev)
  J[:, :, 2, :] = onehot * s[..., None]
  zeros = torch.zeros_like(b)
  Js, biases = [J], [torch.stack([zeros, zeros, b], -1)]
  mus, acts = [zeros.clone()], [(near_lo | near_hi).to(dtype)]

  zrow = torch.zeros((B, model.nv), dtype=dtype, device=dev)
  z1 = torch.zeros((B,), dtype=dtype, device=dev)
  for w in tables.wires:
    pA = _attach_world(kin, w.body_a, w.pos_a, q)
    pB = _attach_world(kin, w.body_b, w.pos_b, q)
    d = pA - pB
    l = torch.sqrt(torch.sum(d * d, -1) + 1e-18)
    n = -d / l[:, None]                    # an impulse on A pulls it toward B
    Jrel = _point_jac(model, kin, w.body_a, pA) - _point_jac(model, kin, w.body_b, pB)
    Jn = (n.unsqueeze(-2) @ Jrel).squeeze(-2)
    stretch = l - w.length
    taut = (stretch - torch.sum(Jn * u, -1) * dt) > 0.0
    bw = torch.clamp(erp * torch.clamp(stretch, min=0.0) / dt, 0.0, max_corr)
    Js.append(torch.stack([zrow, zrow, Jn], -2)[:, None])
    biases.append(torch.stack([z1, z1, bw], -1)[:, None])
    mus.append(z1[:, None])
    acts.append(taut.to(dtype)[:, None])
  for p in tables.pins:
    pA = _attach_world(kin, p.body_a, p.pos_a, q)
    pB = _attach_world(kin, p.body_b, p.pos_b, q)
    Jrel = _point_jac(model, kin, p.body_a, pA) - _point_jac(model, kin, p.body_b, pB)
    err = pA - pB
    Js.append(Jrel[:, None])
    biases.append(torch.clamp(-erp * err / dt, -max_corr, max_corr)[:, None])
    mus.append(torch.full((B, 1), BILATERAL_MU * 10.0, dtype=dtype, device=dev))
    acts.append(torch.ones((B, 1), dtype=dtype, device=dev))
  return torch.cat(Js, 1), torch.cat(biases, 1), torch.cat(mus, 1), torch.cat(acts, 1)


def compliant_forces(model, tables: ConstraintTables, kin, u):
  """(B, nb, 6) world-frame spatial forces at the world origin ([torque,
  force]) of the compliant wires: tension max(k (l - L) + c dl/dt, 0) while
  stretched (a cable cannot push), applied equal and opposite at the attach
  points; what rnea takes as f_ext_w."""
  B = u.shape[0]
  f = torch.zeros((B, model.nb, 6), dtype=u.dtype, device=u.device)
  for w in tables.compliant:
    pA = _attach_world(kin, w.body_a, w.pos_a, u)
    pB = _attach_world(kin, w.body_b, w.pos_b, u)
    d = pA - pB
    l = torch.sqrt(torch.sum(d * d, -1) + 1e-18)
    dn = d / l[:, None]
    vA = dynamics.point_velocity(kin, w.body_a, pA) if w.body_a >= 0 else torch.zeros_like(pA)
    vB = dynamics.point_velocity(kin, w.body_b, pB) if w.body_b >= 0 else torch.zeros_like(pB)
    ldot = torch.sum(dn * (vA - vB), -1)
    stretch = l - w.length
    tension = torch.clamp(w.stiffness * stretch + w.damping * ldot, min=0.0)
    tension = tension * (stretch > 0.0)
    FA = -tension[:, None] * dn            # the force on A, world frame
    if w.body_a >= 0:
      f[:, w.body_a] += torch.cat([sp.cross(pA, FA), FA], -1)
    if w.body_b >= 0:
      f[:, w.body_b] += torch.cat([sp.cross(pB, -FA), -FA], -1)
  return f
