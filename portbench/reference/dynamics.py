"""Rigid-body dynamics of a batch of worlds in plain PyTorch: spatial algebra,
forward kinematics, the RNEA bias, the world-frame mass matrix, integration.

A frozen copy of the system's reference formulation (the sequential FK and
RNEA recursions and the congruence M = sum_b J_b^T I_b J_b), for a floating
base and revolute joints. Every product runs through `@` or einsum, so a
process that allows TF32 matmuls computes it in TF32: that is the control.
"""

from __future__ import annotations

import dataclasses

import torch

from portbench.reference.model import FREE, Model


def cross(a, b):
  return torch.linalg.cross(a, b, dim=-1)


def mv(M, v):
  return (M @ v.unsqueeze(-1)).squeeze(-1)


def mtv(M, v):
  return (M.transpose(-1, -2) @ v.unsqueeze(-1)).squeeze(-1)


def skew(v):
  x, y, z = v.unbind(-1)
  o = torch.zeros_like(x)
  return torch.stack([torch.stack([o, -z, y], -1), torch.stack([z, o, -x], -1),
                      torch.stack([-y, x, o], -1)], -2)


def quat_mul(a, b):
  w1, x1, y1, z1 = a.unbind(-1)
  w2, x2, y2, z2 = b.unbind(-1)
  return torch.stack([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                      w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                      w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                      w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], -1)


def quat_conj(q):
  return torch.cat([q[..., :1], -q[..., 1:]], -1)


def quat_to_mat(q):
  w, x, y, z = q.unbind(-1)
  return torch.stack([
      torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
      torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
      torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1)], -2)


def quat_box_minus(q1, q2):
  """Rotation vector of q1 (x) q2^-1."""
  dq = quat_mul(q1, quat_conj(q2))
  w0 = dq[..., :1]
  dq = dq * torch.sign(torch.where(w0 == 0.0, torch.ones_like(w0), w0))
  w = torch.clamp(dq[..., 0], -1.0, 1.0)
  xyz = dq[..., 1:]
  n = torch.sqrt(torch.sum(xyz * xyz, -1) + 1e-32)
  scale = torch.where(n > 1e-8, 2.0 * torch.atan2(n, w) / n, 2.0 / torch.clamp(w, min=1e-8))
  return scale[..., None] * xyz


def _quat_integrate(q, w, dt):
  """q advanced by the world angular velocity w over dt (exp map), unit."""
  wd = w * dt
  a2 = torch.sum(wd * wd, -1, keepdim=True)
  a = torch.sqrt(a2 + 1e-32)
  sinc = torch.where(a2 > 1e-16, torch.sin(0.5 * a) / a, 0.5 - a2 / 48.0)
  out = quat_mul(torch.cat([torch.cos(0.5 * a), sinc * wd], -1), q)
  return out / torch.sqrt(torch.sum(out * out, -1, keepdim=True) + 1e-12)


# transforms X = (E, r): coordinates of frame A to frame B, E rotation, r
# the origin of B in A's coordinates

def _lift(X, v):
  E, r = X
  for _ in range(v.dim() - r.dim()):
    E, r = E.unsqueeze(-3), r.unsqueeze(-2)
  return E, r


def x_compose(X2, X1):
  return X2[0] @ X1[0], X1[1] + mtv(X1[0], X2[1])


def x_motion(X, v):
  E, r = _lift(X, v)
  w = v[..., :3]
  return torch.cat([mv(E, w), mv(E, v[..., 3:] - cross(r, w))], -1)


def x_motion_inv(X, v):
  E, r = _lift(X, v)
  w = mtv(E, v[..., :3])
  return torch.cat([w, mtv(E, v[..., 3:]) + cross(r, w)], -1)


def x_force_inv(X, f):
  E, r = _lift(X, f)
  fl = mtv(E, f[..., 3:])
  return torch.cat([mtv(E, f[..., :3]) + cross(r, fl), fl], -1)


def x_motion_mat(X):
  E, r = X
  return torch.cat([torch.cat([E, torch.zeros_like(E)], -1),
                    torch.cat([-E @ skew(r), E], -1)], -2)


def cross_motion(v, m):
  return torch.cat([cross(v[..., :3], m[..., :3]),
                    cross(v[..., :3], m[..., 3:]) + cross(v[..., 3:], m[..., :3])], -1)


def cross_force(v, f):
  return torch.cat([cross(v[..., :3], f[..., :3]) + cross(v[..., 3:], f[..., 3:]),
                    cross(v[..., :3], f[..., 3:])], -1)


class Tables:
  """A Model's numbers as tensors of one dtype and device."""

  def __init__(self, model: Model, dtype, device):
    self.m = model

    def t(x):
      return torch.as_tensor(x, dtype=dtype, device=device)

    self.X_rot, self.X_pos, self.axis = t(model.X_rot), t(model.X_pos), t(model.axis)
    self.inertia = t(model.inertia)
    self.actuated, self.torque_limit = t(model.actuated), t(model.torque_limit)
    self.amask = t(model.ancestor_mask())


def _xup(T: Tables, i: int, q):
  """Parent -> body-i transform and the joint's motion subspace S (B, nd, 6)."""
  m = T.m
  qa = m.q_adr[i]
  B = q.shape[0]
  if m.joint[i] == FREE:
    R = quat_to_mat(q[:, qa + 3:qa + 7])
    Z3 = torch.zeros((B, 3, 3), dtype=q.dtype, device=q.device)
    I3 = torch.eye(3, dtype=q.dtype, device=q.device).expand(B, 3, 3)
    XJ = (R.transpose(-1, -2), q[:, qa:qa + 3])
    S = torch.cat([torch.cat([I3, Z3], -1), torch.cat([Z3, R], -1)], -2)
  else:
    a = T.axis[i]
    half = 0.5 * q[:, qa]
    R = quat_to_mat(torch.cat([torch.cos(half)[:, None], torch.sin(half)[:, None] * a], -1))
    XJ = (R.transpose(-1, -2), torch.zeros((B, 3), dtype=q.dtype, device=q.device))
    S = torch.cat([a, torch.zeros_like(a)]).expand(B, 1, 6)
  return x_compose(XJ, (T.X_rot[i].T, T.X_pos[i])), S


def _vj(T: Tables, i: int, S, u):
  va = T.m.v_adr[i]
  return (u[:, va:va + S.shape[-2]].unsqueeze(-2) @ S).squeeze(-2)


@dataclasses.dataclass
class Kin:
  R: torch.Tensor      # (B, nb, 3, 3) body -> world
  p: torch.Tensor      # (B, nb, 3)
  S_w: torch.Tensor    # (B, nv, 6) world-frame motion subspace of each dof


def fk(T: Tables, q, u) -> Kin:
  """Forward kinematics by the per-body recursion."""
  X0, R, p, Sw = [], [], [], []
  for i in range(T.m.nb):
    Xup, S = _xup(T, i, q)
    X0.append(Xup if T.m.parent[i] < 0 else x_compose(Xup, X0[T.m.parent[i]]))
    E, r = X0[i]
    R.append(E.transpose(-1, -2))
    p.append(r)
    Sw.append(x_motion_inv(X0[i], S))
  return Kin(R=torch.stack(R, 1), p=torch.stack(p, 1), S_w=torch.cat(Sw, 1))


def bias_forces(T: Tables, q, u, gravity):
  """h(q, u): Coriolis, centrifugal and gravity forces, by RNEA at qdd = 0."""
  m = T.m
  B = q.shape[0]
  a_base = torch.cat([torch.zeros(3, dtype=q.dtype, device=q.device), -gravity]).expand(B, 6)
  Xup, Ss, v, a, f = [], [], [], [], []
  for i in range(m.nb):
    X, S = _xup(T, i, q)
    Xup.append(X)
    Ss.append(S)
    vJ = _vj(T, i, S, u)
    cJ = (torch.cat([torch.zeros_like(vJ[:, :3]), -cross(vJ[:, :3], vJ[:, 3:])], -1)
          if m.joint[i] == FREE else torch.zeros_like(vJ))
    if m.parent[i] < 0:
      v.append(vJ)
      a.append(x_motion(X, a_base) + cJ + cross_motion(vJ, vJ))
    else:
      v.append(x_motion(X, v[m.parent[i]]) + vJ)
      a.append(x_motion(X, a[m.parent[i]]) + cJ + cross_motion(v[i], vJ))
    I6 = T.inertia[i]
    f.append(a[i] @ I6.T + cross_force(v[i], v[i] @ I6.T))
  tau = [None] * m.nb
  for i in range(m.nb - 1, -1, -1):
    tau[i] = (Ss[i] @ f[i].unsqueeze(-1)).squeeze(-1)
    if m.parent[i] >= 0:
      f[m.parent[i]] = f[m.parent[i]] + x_force_inv(Xup[i], f[i])
  return torch.cat(tau, -1)


def mass_matrix(T: Tables, kin: Kin):
  """M = sum_b J_b^T I_w[b] J_b with world-frame inertias at the origin."""
  Xm = x_motion_mat((kin.R.transpose(-1, -2), kin.p))
  Iw = Xm.transpose(-1, -2) @ T.inertia @ Xm                   # (B, nb, 6, 6)
  Jb = T.amask[None, :, :, None] * kin.S_w[:, None, :, :]       # (B, nb, nv, 6)
  return (Jb @ Iw @ Jb.transpose(-1, -2)).sum(1)


def integrate_q(T: Tables, q, u, dt):
  """q (+) u dt, the quaternion by the exp map of the world angular velocity."""
  parts = []
  for i in range(T.m.nb):
    qa, va = T.m.q_adr[i], T.m.v_adr[i]
    if T.m.joint[i] == FREE:
      quat = q[:, qa + 3:qa + 7]
      parts += [q[:, qa:qa + 3] + u[:, va + 3:va + 6] * dt,
                _quat_integrate(quat, mv(quat_to_mat(quat), u[:, va:va + 3]), dt)]
    else:
      parts.append(q[:, qa:qa + 1] + u[:, va:va + 1] * dt)
  return torch.cat(parts, -1)
