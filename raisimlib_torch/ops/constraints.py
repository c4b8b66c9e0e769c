"""Constraint rows for the contact solver: joint limits.

Counterpart of raisimlib_tpu/ops/constraints.py. Every constraint is a
statically-shaped pseudo-contact row masked by an `active` flag, appended to
the same solver system as the real contacts. Row kinds:
  * "cone"      — frictional contact (mu from the material table)
  * "lin"       — frictionless unilateral row (joint limit, stiff wire): only
                  the 3rd ("normal") component is used
  * "bilateral" — equality row triplet (pin), flagged by the BILATERAL_MU
                  sentinel for the generic solver
Only joint-limit rows are ported; wires, pins and compliant wires raise.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from raisimlib_torch.models.model import JointType

BILATERAL_MU = 1e6


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


def _unported(what: str) -> NotImplementedError:
  return NotImplementedError(
      f"{what} are not ported to raisimlib_torch yet: ROADMAP.md, 'Rest of "
      f"collision and constraints'")


def build_tables(model, joint_limits: bool, wires=(), pins=(),
                 compliant=()) -> ConstraintTables:
  """Limit rows for every dof with a finite URDF limit (1-dof joints only)."""
  if wires:
    raise _unported("stiff wires")
  if pins:
    raise _unported("pin constraints")
  if compliant:
    raise _unported("compliant wires")
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
                          (), (), ())


def _dof_to_q(model, j: int) -> int:
  for i in range(model.nb):
    if JointType(model.joint_types[i]) in (JointType.FREE, JointType.SPHERICAL):
      continue
    if model.v_adr[i] == j:
      return model.q_adr[i]
  raise ValueError(f"dof {j} is not a 1-dof joint dof")


def constraint_rows(model, tables: ConstraintTables, q, u, dt, erp: float,
                    max_corr: float):
  """(J (B,k,3,nv), bias (B,k,3), mu (B,k), active (B,k)) for the limit rows.

  Row frames are final (identity): components 0 and 1 are zero tangents, and
  component 2 is the limited dof with the Baumgarte bias, matching the contact
  convention v_n+ >= b. The one-step lookahead engages a row before impact."""
  if tables.wires or tables.pins:
    raise _unported("stiff wires and pins")
  k = len(tables.limit_vadr)
  B = q.shape[0]
  dtype, dev = q.dtype, q.device
  qi = torch.as_tensor(tables.limit_qadr, device=dev)
  vi = torch.as_tensor(tables.limit_vadr, device=dev)
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
  bias = torch.stack([zeros, zeros, b], -1)
  return J, bias, zeros.clone(), (near_lo | near_hi).to(dtype)
