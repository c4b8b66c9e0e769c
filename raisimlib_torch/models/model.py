"""Robot model: static kinematic tree + inertial parameter tensors.

Counterpart of raisimlib_tpu/models/model.py. The tree topology is static
(Python tuples), so the recursions in ops/dynamics.py unroll over bodies in
Python; the numeric parameters are tensors on the model's device.

Joint conventions:
  * FREE:      q = [pos(3), quat wxyz(4)]  u = [omega_body(3), v_world(3)]
  * REVOLUTE:  q = angle, u = rate, about `axis` in the child body frame
  * PRISMATIC: q = displacement, u = rate, along `axis` in the child body frame
  * SPHERICAL: q = quat wxyz(4), u = omega_body(3)
  * Fixed joints are collapsed into their parent at build time.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Sequence

import numpy as np
import torch

from raisimlib_torch._device import resolve_device


class JointType(enum.IntEnum):
  FREE = 0
  REVOLUTE = 1
  PRISMATIC = 2
  SPHERICAL = 3


_NQ = {JointType.FREE: 7, JointType.REVOLUTE: 1, JointType.PRISMATIC: 1,
       JointType.SPHERICAL: 4}
_NV = {JointType.FREE: 6, JointType.REVOLUTE: 1, JointType.PRISMATIC: 1,
       JointType.SPHERICAL: 3}


def joint_nv(jt) -> int:
  return _NV[JointType(jt)]


def joint_nq(jt) -> int:
  return _NQ[JointType(jt)]


# numeric fields of RobotModel, in declaration order
TENSOR_FIELDS = ("X_rot", "X_pos", "axis", "inertia", "mass", "actuated",
                 "torque_limit", "joint_lo", "joint_hi", "q_init")


@dataclasses.dataclass(frozen=True)
class RobotModel:
  """Bodies are indexed 0..nb-1 in topological order (parent[i] < i); parent
  -1 is the world. Exactly one joint connects body i to its parent."""

  name: str
  parent: tuple
  joint_types: tuple
  q_adr: tuple
  v_adr: tuple
  nq: int
  nv: int
  body_names: tuple
  X_rot: torch.Tensor        # (nb,3,3) parent -> joint frame rotation at q=0
  X_pos: torch.Tensor        # (nb,3)
  axis: torch.Tensor         # (nb,3) joint axis in the child frame
  inertia: torch.Tensor      # (nb,6,6) spatial inertia about the body origin
  mass: torch.Tensor         # (nb,)
  actuated: torch.Tensor     # (nv,)
  torque_limit: torch.Tensor  # (nv,)
  joint_lo: torch.Tensor     # (nv,) +-1e9 = unlimited
  joint_hi: torch.Tensor     # (nv,)
  q_init: torch.Tensor       # (nq,)

  @property
  def nb(self) -> int:
    return len(self.parent)

  @property
  def dtype(self) -> torch.dtype:
    return self.q_init.dtype

  @property
  def device(self) -> torch.device:
    return self.q_init.device


def build_model(name: str, bodies: Sequence[dict], dtype=torch.float32,
                device=None) -> RobotModel:
  """Assemble a RobotModel from per-body spec dicts (same format as the JAX
  package's build_model: parent, joint, axis, pos, rot, mass, com, inertia,
  name, actuated, torque_limit, q_lo, q_hi, q_init). Host-side math is numpy
  float64; only the finished tables are converted, onto `device` (None: the
  card, see _device.resolve_device)."""
  device = resolve_device(device)
  nb = len(bodies)
  parent, jtypes, names = [], [], []
  q_adr, v_adr = [], []
  nq = nv = 0
  X_rot = np.zeros((nb, 3, 3))
  X_pos = np.zeros((nb, 3))
  axis = np.zeros((nb, 3))
  inertia6 = np.zeros((nb, 6, 6))
  mass = np.zeros((nb,))
  actuated, tlim, q_init, lo, hi = [], [], [], [], []

  for i, b in enumerate(bodies):
    p = int(b["parent"])
    if p >= i:
      raise ValueError("bodies must be in topological order")
    jt = JointType(b["joint"])
    if jt == JointType.FREE and p != -1:
      raise ValueError("FREE joints are root-only")
    parent.append(p)
    jtypes.append(int(jt))
    names.append(b.get("name", f"body{i}"))
    q_adr.append(nq)
    v_adr.append(nv)
    nq += _NQ[jt]
    ndof = _NV[jt]
    nv += ndof
    X_rot[i] = np.asarray(b.get("rot", np.eye(3)))
    X_pos[i] = np.asarray(b.get("pos", np.zeros(3)))
    a = np.asarray(b.get("axis", [0.0, 0.0, 1.0]), dtype=np.float64)
    axis[i] = a / max(np.linalg.norm(a), 1e-12)
    m = float(b["mass"])
    mass[i] = m
    com = np.asarray(b.get("com", np.zeros(3)), dtype=np.float64)
    I_com = np.asarray(b.get("inertia", np.zeros((3, 3))), dtype=np.float64)
    C = np.array([[0, -com[2], com[1]], [com[2], 0, -com[0]], [-com[1], com[0], 0]])
    I_o = I_com + m * (C @ C.T)
    h = m * com
    H = np.array([[0, -h[2], h[1]], [h[2], 0, -h[0]], [-h[1], h[0], 0]])
    inertia6[i] = np.block([[I_o, H], [H.T, m * np.eye(3)]])
    act = bool(b.get("actuated", jt != JointType.FREE))
    actuated += [1.0 if act else 0.0] * ndof
    tlim += [float(b.get("torque_limit", 1e9))] * ndof
    if jt in (JointType.FREE, JointType.SPHERICAL):
      lo += [-1e9] * ndof
      hi += [1e9] * ndof
    else:
      lo.append(float(b.get("q_lo", -1e9)))
      hi.append(float(b.get("q_hi", 1e9)))
    q0 = b.get("q_init")
    if q0 is None:
      q0 = {JointType.FREE: [0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0],
            JointType.SPHERICAL: [1.0, 0.0, 0.0, 0.0]}.get(jt, [0.0])
    q_init += list(np.atleast_1d(np.asarray(q0, dtype=np.float64)))

  assert len(q_init) == nq

  def t(x):
    return torch.as_tensor(np.asarray(x, np.float64), dtype=dtype, device=device)

  return RobotModel(
      name=name, parent=tuple(parent), joint_types=tuple(jtypes),
      q_adr=tuple(q_adr), v_adr=tuple(v_adr), nq=nq, nv=nv,
      body_names=tuple(names),
      X_rot=t(X_rot), X_pos=t(X_pos), axis=t(axis), inertia=t(inertia6),
      mass=t(mass), actuated=t(actuated), torque_limit=t(tlim),
      joint_lo=t(lo), joint_hi=t(hi), q_init=t(q_init))
