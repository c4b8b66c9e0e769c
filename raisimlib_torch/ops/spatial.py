"""Spatial (Plücker) algebra on batched tensors.

Counterpart of raisimlib_tpu/ops/spatial.py. Every function broadcasts over
leading dimensions. Conventions (Featherstone):
  * motion vectors [angular(3), linear(3)], force vectors [moment(3), force(3)];
  * quaternions [w, x, y, z], unit norm;
  * a transform X from frame A to frame B is the pair (E, r): E (..., 3, 3)
    takes A-coordinates to B-coordinates and r (..., 3) is B's origin in A.

A vector argument may carry one or more extra dimensions between the batch
dimensions of X and its last axis (e.g. a (B, nd, 6) stack of subspace rows
against a (B, 3, 3) transform); `_lift` inserts the matching axes into X.
"""

from __future__ import annotations

import torch


def cross(a, b):
  return torch.linalg.cross(a, b, dim=-1)


def _mv(M, v):
  """M v for M (..., n, n), v (..., n)."""
  return (M @ v.unsqueeze(-1)).squeeze(-1)


def _mtv(M, v):
  """M^T v."""
  return (M.transpose(-1, -2) @ v.unsqueeze(-1)).squeeze(-1)


def _lift(X, v):
  E, r = X
  extra = (v.dim() - 1) - (r.dim() - 1)
  for _ in range(extra):
    E = E.unsqueeze(-3)
    r = r.unsqueeze(-2)
  return E, r


def skew(v):
  """3-vector -> 3x3 skew matrix such that skew(v) @ u = v x u."""
  x, y, z = v[..., 0], v[..., 1], v[..., 2]
  zero = torch.zeros_like(x)
  return torch.stack([torch.stack([zero, -z, y], -1),
                      torch.stack([z, zero, -x], -1),
                      torch.stack([-y, x, zero], -1)], -2)


def quat_mul(q1, q2):
  """Hamilton product q1 (x) q2."""
  w1, x1, y1, z1 = q1.unbind(-1)
  w2, x2, y2, z2 = q2.unbind(-1)
  return torch.stack([
      w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
      w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
      w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
      w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
  ], -1)


def quat_conj(q):
  # negation, not a product with a host-made sign vector, whose copy to the
  # card would synchronise every call
  return torch.cat([q[..., :1], -q[..., 1:]], -1)


def quat_normalize(q, eps=1e-12):
  return q / torch.sqrt(torch.sum(q * q, -1, keepdim=True) + eps)


def quat_rotate(q, v):
  """Rotate v (..., 3) by the unit quaternion q (..., 4): v_world = R(q) v_body."""
  w, u = q[..., :1], q[..., 1:]
  uv = cross(u, v)
  return v + 2.0 * (w * uv + cross(u, uv))


def quat_rotate_inv(q, v):
  return quat_rotate(quat_conj(q), v)


def quat_to_mat(q):
  """Unit quaternion -> rotation matrix R with v_world = R v_body."""
  w, x, y, z = q.unbind(-1)
  xx, yy, zz = x * x, y * y, z * z
  xy, xz, yz = x * y, x * z, y * z
  wx, wy, wz = w * x, w * y, w * z
  return torch.stack([
      torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], -1),
      torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], -1),
      torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], -1),
  ], -2)


def mat_to_quat(R):
  """Rotation matrix (..., 3, 3) -> unit quaternion [w, x, y, z]: the four
  candidates (one per largest diagonal pivot), selected branch-free."""
  m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
  m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
  m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
  tr = m00 + m11 + m22

  def root(x):
    return torch.sqrt(torch.clamp(x, min=1e-12)) * 2.0

  s = root(1.0 + tr)
  cw = torch.stack([0.25 * s, (m21 - m12) / s, (m02 - m20) / s, (m10 - m01) / s], -1)
  s = root(1.0 + m00 - m11 - m22)
  cx = torch.stack([(m21 - m12) / s, 0.25 * s, (m01 + m10) / s, (m02 + m20) / s], -1)
  s = root(1.0 - m00 + m11 - m22)
  cy = torch.stack([(m02 - m20) / s, (m01 + m10) / s, 0.25 * s, (m12 + m21) / s], -1)
  s = root(1.0 - m00 - m11 + m22)
  cz = torch.stack([(m10 - m01) / s, (m02 + m20) / s, (m12 + m21) / s, 0.25 * s], -1)
  use_w = tr > 0.0
  use_x = ~use_w & (m00 >= m11) & (m00 >= m22)
  use_y = ~use_w & ~use_x & (m11 >= m22)
  q = torch.where(use_w[..., None], cw,
                  torch.where(use_x[..., None], cx, torch.where(use_y[..., None], cy, cz)))
  return quat_normalize(q)


def quat_from_axis_angle(axis, angle):
  """axis (..., 3) unit, angle (...) -> quaternion (..., 4)."""
  half = 0.5 * angle
  return torch.cat([torch.cos(half)[..., None],
                    torch.sin(half)[..., None] * axis], -1)


def quat_exp(omega_dt):
  """Exp map: rotation vector (..., 3) -> unit quaternion. Safe at zero."""
  angle2 = torch.sum(omega_dt * omega_dt, -1, keepdim=True)
  angle = torch.sqrt(angle2 + 1e-32)
  half = 0.5 * angle
  sinc_half = torch.where(angle2 > 1e-16, torch.sin(half) / angle,
                          0.5 - angle2 / 48.0)
  return torch.cat([torch.cos(half), sinc_half * omega_dt], -1)


def quat_integrate(q, omega_world, dt):
  """Integrate a unit quaternion by a world-frame angular velocity over dt."""
  return quat_normalize(quat_mul(quat_exp(omega_world * dt), q))


def quat_box_minus(q1, q2):
  """Rotation-vector difference log(q1 (x) q2^-1). Safe at identity."""
  dq = quat_mul(q1, quat_conj(q2))
  w0 = dq[..., :1]
  dq = dq * torch.sign(torch.where(w0 == 0.0, torch.ones_like(w0), w0))
  w = torch.clamp(dq[..., 0], -1.0, 1.0)
  xyz = dq[..., 1:]
  n = torch.sqrt(torch.sum(xyz * xyz, -1) + 1e-32)
  angle = 2.0 * torch.atan2(n, w)
  scale = torch.where(n > 1e-8, angle / n, 2.0 / torch.clamp(w, min=1e-8))
  return scale[..., None] * xyz


def xform_identity(dtype=torch.float32, device=None):
  return (torch.eye(3, dtype=dtype, device=device),
          torch.zeros(3, dtype=dtype, device=device))


def xform_compose(X2, X1):
  """(A->B = X1) then (B->C = X2) -> A->C."""
  E2, r2 = X2
  E1, r1 = X1
  return E2 @ E1, r1 + _mtv(E1, r2)


def xform_inv(X):
  E, r = X
  return E.transpose(-1, -2), -_mv(E, r)


def xform_point(X, p):
  """A point's A-coordinates to B-coordinates: E (p - r)."""
  E, r = X
  return _mv(E, p - r)


def xform_point_inv(X, p):
  E, r = X
  return _mtv(E, p) + r


def xform_motion(X, v):
  """Motion vector from A-coords to B-coords."""
  E, r = _lift(X, v)
  w, vl = v[..., :3], v[..., 3:]
  return torch.cat([_mv(E, w), _mv(E, vl - cross(r, w))], -1)


def xform_motion_inv(X, v):
  """Motion vector from B-coords back to A-coords."""
  E, r = _lift(X, v)
  w = _mtv(E, v[..., :3])
  return torch.cat([w, _mtv(E, v[..., 3:]) + cross(r, w)], -1)


def xform_force(X, f):
  """Force vector from A-coords to B-coords."""
  E, r = _lift(X, f)
  n, fl = f[..., :3], f[..., 3:]
  return torch.cat([_mv(E, n - cross(r, fl)), _mv(E, fl)], -1)


def xform_force_inv(X, f):
  """Force vector from B-coords back to A-coords."""
  E, r = _lift(X, f)
  fl = _mtv(E, f[..., 3:])
  return torch.cat([_mtv(E, f[..., :3]) + cross(r, fl), fl], -1)


def xform_motion_mat(X):
  """Dense 6x6 motion transform [E 0; -E skew(r) E]."""
  E, r = X
  top = torch.cat([E, torch.zeros_like(E)], -1)
  bot = torch.cat([-E @ skew(r), E], -1)
  return torch.cat([top, bot], -2)


def cross_motion(v, m):
  """v x_m m."""
  w, vl = v[..., :3], v[..., 3:]
  mw, ml = m[..., :3], m[..., 3:]
  return torch.cat([cross(w, mw), cross(w, ml) + cross(vl, mw)], -1)


def cross_force(v, f):
  """v x* f."""
  w, vl = v[..., :3], v[..., 3:]
  n, fl = f[..., :3], f[..., 3:]
  return torch.cat([cross(w, n) + cross(vl, fl), cross(w, fl)], -1)


def spatial_inertia(mass, com, inertia_com):
  """The 6x6 spatial inertia about the body-frame origin from the mass, the
  COM (..., 3) and the rotational inertia (..., 3, 3) about the COM:
  [[I_com + m C C^T, skew(m com)], [skew(m com)^T, m 1]], C = skew(com)."""
  com = torch.as_tensor(com)
  inertia_com = torch.as_tensor(inertia_com, dtype=com.dtype, device=com.device)
  mass = torch.as_tensor(mass, dtype=com.dtype, device=com.device)
  C = skew(com)
  I_o = inertia_com + mass[..., None, None] * (C @ C.transpose(-1, -2))
  h = skew(mass[..., None] * com)
  m_eye = mass[..., None, None] * torch.eye(3, dtype=com.dtype, device=com.device)
  return torch.cat([torch.cat([I_o, h], -1), torch.cat([h.transpose(-1, -2), m_eye], -1)], -2)


def kinetic_energy(I6, v):
  return 0.5 * torch.sum(v * _mv(I6, v), -1)


def force_at_point(point_w, force_w, torque_w=None):
  """World wrench [torque at the world origin, force] of a force applied at
  a world point, plus an optional pure torque: what rnea and the step take
  as f_ext_w."""
  tau = cross(point_w, force_w)
  if torque_w is not None:
    tau = tau + torque_w
  return torch.cat([tau, force_w], -1)
