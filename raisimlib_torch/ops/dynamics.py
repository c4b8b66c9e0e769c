"""Articulated-body dynamics on batched worlds: FK, RNEA, CRBA, ABA, Jacobians,
energy.

Counterpart of raisimlib_tpu/ops/dynamics.py. The tree is static (tuples in
RobotModel), so each recursion is a Python loop over bodies; every tensor
carries a leading batch dimension B of worlds where the JAX package uses
`vmap`: q (B, nq), u (B, nv).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from raisimlib_torch.models.model import JointType, RobotModel, joint_nv
from raisimlib_torch.ops import spatial as sp


@dataclasses.dataclass
class KinData:
  """Forward-kinematics products consumed by collision, Jacobians and the solver."""

  R: torch.Tensor      # (B,nb,3,3) body->world rotations
  p: torch.Tensor      # (B,nb,3)   body origins in world
  S_w: torch.Tensor    # (B,nv,6)   world-frame motion subspace per dof
  vel6: torch.Tensor   # (B,nb,6)   body twists, world frame at the world origin
  Xup_E: torch.Tensor  # (B,nb,3,3) parent->body rotation
  Xup_r: torch.Tensor  # (B,nb,3)   parent->body translation (parent coords)


def _joint_X_and_S(model: RobotModel, i: int, q):
  """Joint transform (E, r) and motion subspace S (B, nd, 6) in body coords."""
  jt = JointType(model.joint_types[i])
  qa = model.q_adr[i]
  B = q.shape[0]
  dtype, dev = q.dtype, q.device
  if jt == JointType.FREE:
    R = sp.quat_to_mat(q[:, qa + 3:qa + 7])
    E, r = R.transpose(-1, -2), q[:, qa:qa + 3]
    Z3 = torch.zeros((B, 3, 3), dtype=dtype, device=dev)
    I3 = torch.eye(3, dtype=dtype, device=dev).expand(B, 3, 3)
    S = torch.cat([torch.cat([I3, Z3], -1), torch.cat([Z3, R], -1)], -2)
  elif jt == JointType.REVOLUTE:
    a = model.axis[i]
    R = sp.quat_to_mat(sp.quat_from_axis_angle(a, q[:, qa]))
    E, r = R.transpose(-1, -2), torch.zeros((B, 3), dtype=dtype, device=dev)
    S = torch.cat([a, torch.zeros_like(a)]).expand(B, 1, 6)
  elif jt == JointType.PRISMATIC:
    a = model.axis[i]
    E = torch.eye(3, dtype=dtype, device=dev).expand(B, 3, 3)
    r = a * q[:, qa:qa + 1]
    S = torch.cat([torch.zeros_like(a), a]).expand(B, 1, 6)
  elif jt == JointType.SPHERICAL:
    R = sp.quat_to_mat(q[:, qa:qa + 4])
    E, r = R.transpose(-1, -2), torch.zeros((B, 3), dtype=dtype, device=dev)
    S = torch.cat([torch.eye(3, dtype=dtype, device=dev),
                   torch.zeros((3, 3), dtype=dtype, device=dev)], -1).expand(B, 3, 6)
  else:
    raise NotImplementedError(jt)
  return (E, r), S


def _xup(model: RobotModel, i: int, q):
  """X_up[i]: parent-body coords -> body-i coords."""
  X_J, S = _joint_X_and_S(model, i, q)
  X_tree = (model.X_rot[i].T, model.X_pos[i])
  return sp.xform_compose(X_J, X_tree), S


def _vj(model: RobotModel, i: int, S, u):
  va = model.v_adr[i]
  ui = u[:, va:va + S.shape[-2]]
  return (ui.unsqueeze(-2) @ S).squeeze(-2)


def _joint_cj(model: RobotModel, i: int, vJ):
  """cJ = S-dot u: zero except the FREE joint's [0, -w_b x v_b]."""
  if JointType(model.joint_types[i]) == JointType.FREE:
    return torch.cat([torch.zeros_like(vJ[:, :3]), -sp.cross(vJ[:, :3], vJ[:, 3:])], -1)
  return torch.zeros_like(vJ)


def fk(model: RobotModel, q, u=None) -> KinData:
  """Forward kinematics by the per-body sequential recursion."""
  nb = model.nb
  if u is None:
    u = torch.zeros((q.shape[0], model.nv), dtype=q.dtype, device=q.device)
  X0 = [None] * nb
  v = [None] * nb
  Xup_E, Xup_r, R_list, p_list, vel6_w = [], [], [], [], []
  Sw_rows = [None] * nb
  for i in range(nb):
    p_idx = model.parent[i]
    Xup, S = _xup(model, i, q)
    Xup_E.append(Xup[0])
    Xup_r.append(Xup[1])
    vJ = _vj(model, i, S, u)
    if p_idx < 0:
      X0[i], v[i] = Xup, vJ
    else:
      X0[i] = sp.xform_compose(Xup, X0[p_idx])
      v[i] = sp.xform_motion(Xup, v[p_idx]) + vJ
    E, r = X0[i]
    R_list.append(E.transpose(-1, -2))
    p_list.append(r)
    Sw_rows[i] = sp.xform_motion_inv(X0[i], S)        # (B, nd, 6)
    vel6_w.append(sp.xform_motion_inv(X0[i], v[i]))
  return KinData(R=torch.stack(R_list, 1), p=torch.stack(p_list, 1),
                 S_w=torch.cat(Sw_rows, 1), vel6=torch.stack(vel6_w, 1),
                 Xup_E=torch.stack(Xup_E, 1), Xup_r=torch.stack(Xup_r, 1))


def ancestor_dof_mask(model: RobotModel) -> np.ndarray:
  """(nb, nv) static 0/1 mask: dof j moves body b iff j's body is an ancestor-or-self."""
  mask = np.zeros((model.nb, model.nv), dtype=np.float64)
  for b in range(model.nb):
    k = b
    while k >= 0:
      va = model.v_adr[k]
      mask[b, va:va + joint_nv(model.joint_types[k])] = 1.0
      k = model.parent[k]
  return mask


def point_jacobian(model: RobotModel, kin: KinData, body: int, pt_w):
  """(B, 3, nv) world-frame point Jacobian: v_pt = J @ u. `body` is static."""
  mask = torch.as_tensor(ancestor_dof_mask(model)[body], dtype=pt_w.dtype,
                         device=pt_w.device)
  ang, lin = kin.S_w[..., :3], kin.S_w[..., 3:]
  cols = lin + sp.cross(ang, pt_w.unsqueeze(-2))
  return (cols * mask[:, None]).transpose(-1, -2)


def rnea(model: RobotModel, q, u, qdd, gravity, f_ext_w=None):
  """Recursive Newton-Euler. `f_ext_w`: optional (B, nb, 6) world-frame
  spatial forces at the world origin, one per body."""
  nb = model.nb
  B = q.shape[0]
  a_base = torch.cat([torch.zeros(3, dtype=q.dtype, device=q.device),
                      -gravity.to(q.dtype)]).expand(B, 6)
  X0, Xup, Ss = [None] * nb, [None] * nb, [None] * nb
  v, a, f = [None] * nb, [None] * nb, [None] * nb
  for i in range(nb):
    p_idx = model.parent[i]
    Xup[i], S = _xup(model, i, q)
    Ss[i] = S
    vJ = _vj(model, i, S, u)
    va = model.v_adr[i]
    qddi = qdd[:, va:va + S.shape[-2]]
    aJ = (qddi.unsqueeze(-2) @ S).squeeze(-2) + _joint_cj(model, i, vJ)
    if p_idx < 0:
      X0[i], v[i] = Xup[i], vJ
      a[i] = sp.xform_motion(Xup[i], a_base) + aJ + sp.cross_motion(v[i], vJ)
    else:
      X0[i] = sp.xform_compose(Xup[i], X0[p_idx])
      v[i] = sp.xform_motion(Xup[i], v[p_idx]) + vJ
      a[i] = sp.xform_motion(Xup[i], a[p_idx]) + aJ + sp.cross_motion(v[i], vJ)
    I6 = model.inertia[i]
    f[i] = a[i] @ I6.T + sp.cross_force(v[i], v[i] @ I6.T)
    if f_ext_w is not None:
      f[i] = f[i] - sp.xform_force(X0[i], f_ext_w[:, i])
  tau = [None] * nb
  for i in range(nb - 1, -1, -1):
    tau[i] = (Ss[i] @ f[i].unsqueeze(-1)).squeeze(-1)
    p_idx = model.parent[i]
    if p_idx >= 0:
      f[p_idx] = f[p_idx] + sp.xform_force_inv(Xup[i], f[i])
  return torch.cat(tau, -1)          # bodies are in dof order (v_adr ascending)


def nonlinearities(model, q, u, gravity, f_ext_w=None):
  """h(q, u) = C u + g - f_ext term."""
  return rnea(model, q, u, torch.zeros_like(u), gravity, f_ext_w)


def inertia_world(model: RobotModel, kin: KinData):
  """(B, nb, 6, 6) body spatial inertias in world coords at the world origin."""
  Xm = sp.xform_motion_mat((kin.R.transpose(-1, -2), kin.p))
  return Xm.transpose(-1, -2) @ model.inertia @ Xm


def crba_w(model: RobotModel, q, kin: KinData | None = None):
  """Mass matrix by the world-frame congruence M = sum_b J_b^T I_w[b] J_b."""
  if kin is None:
    kin = fk(model, q)
  mask = torch.as_tensor(ancestor_dof_mask(model), dtype=q.dtype, device=q.device)
  Iw = inertia_world(model, kin)                          # (B, nb, 6, 6)
  Jb = mask[None, :, :, None] * kin.S_w[:, None, :, :]    # (B, nb, nv, 6)
  return (Jb @ Iw @ Jb.transpose(-1, -2)).sum(1)


def integrate_q(model: RobotModel, q, u, dt):
  """Semi-implicit position update q' = q (+) u dt (quaternion exp-map for FREE)."""
  parts = []
  for i in range(model.nb):
    jt = JointType(model.joint_types[i])
    qa, va = model.q_adr[i], model.v_adr[i]
    if jt == JointType.FREE:
      quat = q[:, qa + 3:qa + 7]
      w_w = sp._mv(sp.quat_to_mat(quat), u[:, va:va + 3])
      parts += [q[:, qa:qa + 3] + u[:, va + 3:va + 6] * dt,
                sp.quat_integrate(quat, w_w, dt)]
    elif jt == JointType.SPHERICAL:
      quat = q[:, qa:qa + 4]
      w_w = sp._mv(sp.quat_to_mat(quat), u[:, va:va + 3])
      parts.append(sp.quat_integrate(quat, w_w, dt))
    else:
      parts.append(q[:, qa:qa + 1] + u[:, va:va + 1] * dt)
  return torch.cat(parts, -1)        # bodies are in coordinate order


def aba(model: RobotModel, q, u, tau, gravity, f_ext_w=None):
  """Articulated-body algorithm: qdd (B, nv) from q (B, nq), u, tau (B, nv)
  and optional world-frame spatial forces `f_ext_w` (B, nb, 6) at the world
  origin, one per body. O(nb) with the recursions unrolled over bodies."""
  nb = model.nb
  B = q.shape[0]
  X0, Xup, Ss = [None] * nb, [None] * nb, [None] * nb
  v, c, IA, pA = [None] * nb, [None] * nb, [None] * nb, [None] * nb
  for i in range(nb):
    p_idx = model.parent[i]
    Xup[i], S = _xup(model, i, q)
    Ss[i] = S
    vJ = _vj(model, i, S, u)
    if p_idx < 0:
      X0[i], v[i] = Xup[i], vJ
    else:
      X0[i] = sp.xform_compose(Xup[i], X0[p_idx])
      v[i] = sp.xform_motion(Xup[i], v[p_idx]) + vJ
    c[i] = sp.cross_motion(v[i], vJ) + _joint_cj(model, i, vJ)
    I6 = model.inertia[i]
    IA[i] = I6.expand(B, 6, 6)
    pA[i] = sp.cross_force(v[i], v[i] @ I6.T)
    if f_ext_w is not None:
      pA[i] = pA[i] - sp.xform_force(X0[i], f_ext_w[:, i])

  U, Dinv, uu = [None] * nb, [None] * nb, [None] * nb
  for i in range(nb - 1, -1, -1):
    S = Ss[i]                                       # (B, nd, 6)
    va, nd = model.v_adr[i], S.shape[-2]
    U[i] = IA[i] @ S.transpose(-1, -2)              # (B, 6, nd)
    D = S @ U[i]                                    # (B, nd, nd)
    Dinv[i] = 1.0 / D if nd == 1 else torch.linalg.inv(D)
    uu[i] = tau[:, va:va + nd] - (S @ pA[i].unsqueeze(-1)).squeeze(-1)
    p_idx = model.parent[i]
    if p_idx >= 0:
      Ia = IA[i] - U[i] @ Dinv[i] @ U[i].transpose(-1, -2)
      pa = (pA[i] + (Ia @ c[i].unsqueeze(-1)).squeeze(-1)
            + (U[i] @ (Dinv[i] @ uu[i].unsqueeze(-1))).squeeze(-1))
      Xm = sp.xform_motion_mat(Xup[i])
      IA[p_idx] = IA[p_idx] + Xm.transpose(-1, -2) @ Ia @ Xm
      pA[p_idx] = pA[p_idx] + sp.xform_force_inv(Xup[i], pa)

  a_base = torch.cat([torch.zeros(3, dtype=q.dtype, device=q.device),
                      -gravity.to(q.dtype)]).expand(B, 6)
  a, qdd = [None] * nb, [None] * nb
  for i in range(nb):
    p_idx = model.parent[i]
    ai = sp.xform_motion(Xup[i], a_base if p_idx < 0 else a[p_idx]) + c[i]
    S = Ss[i]
    qdd[i] = (Dinv[i] @ (uu[i] - (U[i].transpose(-1, -2) @ ai.unsqueeze(-1)).squeeze(-1))
              .unsqueeze(-1)).squeeze(-1)           # (B, nd)
    a[i] = ai + (qdd[i].unsqueeze(-2) @ S).squeeze(-2)
  return torch.cat(qdd, -1)          # bodies are in dof order (v_adr ascending)


def energy(model: RobotModel, q, u, gravity):
  """(kinetic, potential) energies of each world, (B,) each."""
  kin = fk(model, q, u)
  g = gravity.to(q.dtype)
  ke = pe = 0.0
  for i in range(model.nb):
    # world-frame twist at the world origin -> body frame at the body origin
    vb = sp.xform_motion((kin.R[:, i].transpose(-1, -2), kin.p[:, i]), kin.vel6[:, i])
    ke = ke + 0.5 * (vb * (vb @ model.inertia[i].T)).sum(-1)
    m = model.mass[i]
    h = model.inertia[i][:3, 3:]                    # skew(m com)
    com_b = torch.stack([h[2, 1], h[0, 2], h[1, 0]]) / torch.clamp(m, min=1e-12)
    com_w = kin.p[:, i] + sp._mv(kin.R[:, i], com_b.expand(q.shape[0], 3))
    pe = pe - m * (com_w @ g)
  return ke, pe
