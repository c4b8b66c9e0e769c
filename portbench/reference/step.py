"""One physics step of a batch of ANYmal worlds, and the scene it steps.

The step is the system's, written out plainly: implicit PD torques, clamped;
FK, the mass matrix (with dt kd on its diagonal) and the bias forces;
contacts with the ground or a heightmap, their rows in the contact frames
(t1, t2, n) with a Baumgarte bias; one row per joint limit, engaged by a
one-step lookahead; the rows of W = J M^-1 and the free velocity from the
Cholesky factor of M; the Gauss-Seidel solve; semi-implicit integration.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import collide, dynamics, model, solve

ERP, SLOP, MAX_CORRECTION = 0.2, 1e-4, 1.0
MU, RESTITUTION, THRESHOLD = 0.8, 0.0, 0.001


def chol(A, eps: float = 1e-12):
  """Lower Cholesky factor, column by column, pivots clamped at eps."""
  n = A.shape[-1]
  cols = []
  for j in range(n):
    s = A[..., :, j]
    for k in range(j):
      s = s - cols[k] * cols[k][..., j:j + 1]
    d = torch.sqrt(torch.clamp(s[..., j:j + 1], min=eps))
    cols.append(torch.where(torch.arange(n, device=A.device) >= j, s / d, torch.zeros_like(s)))
  return torch.stack(cols, -1)


def solve_lower(L, B):
  rows = []
  for i in range(L.shape[-1]):
    r = B[..., i, :]
    for k in range(i):
      r = r - L[..., i, k:k + 1] * rows[k]
    rows.append(r / L[..., i, i:i + 1])
  return torch.stack(rows, -2)


def tangent_frames(n):
  """Rows (t1, t2, n) for unit normals n (..., 3), t1 = n x (the axis least
  aligned with n)."""
  ax = n.abs()
  eye = torch.eye(3, dtype=n.dtype, device=n.device)
  px = (ax[..., 0] <= ax[..., 1]) & (ax[..., 0] <= ax[..., 2])
  py = ~px & (ax[..., 1] <= ax[..., 2])
  a = torch.where(px[..., None], eye[0], torch.where(py[..., None], eye[1], eye[2]))
  t1 = torch.linalg.cross(n, a)
  t1 = t1 / torch.sqrt(torch.sum(t1 * t1, -1, keepdim=True) + 1e-18)
  return torch.stack([t1, torch.linalg.cross(n, t1), n], -2)


class Scene:
  """The scene of a configuration's `world` section (an ANYmal-class robot
  on the ground plane or on a heightmap), in `dtype` on `device`."""

  def __init__(self, world: dict, dtype=torch.float64, device="cpu"):
    kinds = [o["type"] for o in world["objects"]]
    if sorted(kinds) not in (["ground", "urdf"], ["heightmap", "urdf"]):
      raise ValueError(f"objects {kinds}: the reference holds one robot on a ground or heightmap")
    robot = next(o for o in world["objects"] if o["type"] == "urdf")
    if robot["model"] != "anymal":
      raise ValueError(f"model {robot['model']!r}: the reference builds the ANYmal-class robot")
    bodies, geoms = model.parse_urdf(model.anymal_urdf())
    self.model = m = model.build_model(bodies)
    self.T = dynamics.Tables(m, dtype, device)
    self.dt = float(world["dt"])
    self.gravity = torch.tensor(world.get("gravity", (0.0, 0.0, -9.81)), dtype=dtype,
                                device=device)
    t = dict(dtype=dtype, device=device)
    corners = torch.tensor(collide.CORNERS, **t)
    self.pair_geoms = [dict(g, offset_pos_t=torch.tensor(g["offset_pos"], **t),
                            offset_rot_t=torch.tensor(g["offset_rot"], **t),
                            params_t=torch.tensor(g["params"], **t),
                            corners_t=torch.tensor(g["params"][:3], **t) * corners)
                       for g in geoms]
    slot_body = [g["body"] for g in geoms for _ in range(1 if g["gtype"] == 0 else 8)]
    self.n_slots = len(slot_body)
    self.slot_mask = self.T.amask[torch.as_tensor(slot_body, device=device)]   # (nc, nv)
    ground = next(o for o in world["objects"] if o["type"] in ("ground", "heightmap"))
    self.ground_height = float(ground.get("height", 0.0))
    self.field_size = tuple(ground.get("size", (0.0, 0.0)))
    self.has_field = ground["type"] == "heightmap"
    kp, kd = float(world["pd_gains"]["kp"]), float(world["pd_gains"]["kd"])
    act = self.T.actuated
    self.kp, self.D = kp * act, kd * act
    limit_v = [j for j in range(m.nv) if m.joint_lo[j] > -1e8 or m.joint_hi[j] < 1e8]
    self.limit_v = torch.as_tensor(limit_v, device=device)
    self.limit_q = torch.as_tensor([m.q_adr[m.v_adr.index(j)] for j in limit_v], device=device)
    self.lim_lo = torch.tensor(m.joint_lo[limit_v], **t)
    self.lim_hi = torch.tensor(m.joint_hi[limit_v], **t)
    self.limit_onehot = torch.zeros((len(limit_v), m.nv), **t)
    self.limit_onehot[torch.arange(len(limit_v)), limit_v] = 1.0
    jq = np.zeros(m.nv, dtype=np.int64)
    jmask = np.zeros(m.nv)
    for i in range(m.nb):
      if m.joint[i] == model.REVOLUTE:
        jq[m.v_adr[i]], jmask[m.v_adr[i]] = m.q_adr[i], 1.0
    self.jq, self.jmask = torch.as_tensor(jq, device=device), torch.tensor(jmask, **t)
    self.kinds = ("cone",) * self.n_slots + ("lin",) * len(limit_v)
    self.dtype, self.device = dtype, device

  def field(self, heights):
    c = torch.zeros(2, dtype=heights.dtype, device=heights.device)
    return collide.Field(heights, c, self.field_size)

  def step(self, q, u, pd, heights=None):
    """(q', u') of the worlds (q (B, nq), u (B, nv)) under PD targets pd
    (B, nv) and no feedforward torque; heights (B, nx, ny) on a heightmap."""
    return self.step_margin(q, u, pd, heights)[:2]

  def step_margin(self, q, u, pd, heights=None):
    """(q', u', margin): the step, and each world's activation margin, the
    smallest |depth| over its contact slots and |q + u dt - limit| over its
    joint-limit rows (B,)."""
    T, m, dt = self.T, self.model, self.dt
    B, nv = q.shape[0], m.nv
    tau = self.kp * (pd - q[:, self.jq] * self.jmask) * T.actuated * self.jmask
    tau = torch.minimum(torch.maximum(tau, -T.torque_limit), T.torque_limit)
    kin = dynamics.fk(T, q, u)
    field = self.field(heights) if self.has_field else None
    pos, nrm, depth, active = collide.collide(self, kin, field)
    M = dynamics.mass_matrix(T, kin) + dt * torch.diag(self.D)
    h = dynamics.bias_forces(T, q, u, self.gravity)

    mdiff, nc = self.slot_mask, self.n_slots
    ang, lin = kin.S_w[:, None, :, :3], kin.S_w[:, None, :, 3:]
    cols = lin + torch.linalg.cross(ang.expand(-1, nc, -1, -1),
                                    pos[:, :, None, :].expand(-1, -1, nv, -1))
    Jc = (cols * mdiff[:, :, None]).transpose(-1, -2)                # (B, nc, 3, nv)
    J = tangent_frames(nrm) @ Jc
    vn = (J @ u[:, None, :, None])[..., 2, 0]
    b = torch.maximum(torch.where(vn < -THRESHOLD, -RESTITUTION * vn, torch.zeros_like(vn)),
                      torch.clamp(ERP * torch.clamp(depth - SLOP, min=0.0) / dt,
                                  max=MAX_CORRECTION))
    zc = torch.zeros_like(b)
    bias = torch.stack([zc, zc, b], -1)

    k = self.limit_v.numel()
    qp = q[:, self.limit_q] + u[:, self.limit_v] * dt
    near_hi, near_lo = qp > self.lim_hi, qp < self.lim_lo
    viol = torch.maximum(self.lim_lo - qp, qp - self.lim_hi)
    bl = torch.clamp(ERP * torch.clamp(viol, min=0.0) / dt, 0.0, MAX_CORRECTION)
    Jl = torch.zeros((B, k, 3, nv), dtype=q.dtype, device=q.device)
    Jl[:, :, 2, :] = self.limit_onehot * torch.where(near_hi, -1.0, 1.0).to(q.dtype)[..., None]
    zl = torch.zeros_like(bl)
    J = torch.cat([J, Jl], 1)
    bias = torch.cat([bias, torch.stack([zl, zl, bl], -1)], 1)
    mu = torch.cat([torch.full_like(b, MU), zl], 1)
    active = torch.cat([active.to(q.dtype), (near_lo | near_hi).to(q.dtype)], 1)

    L = chol(M)
    invL = solve_lower(L, torch.eye(nv, dtype=q.dtype, device=q.device).expand(B, nv, nv))
    invLt = invL.transpose(-1, -2)
    nr = J.shape[1]
    W = ((J.reshape(B, nr * 3, nv) @ invLt) @ invL).reshape(J.shape)
    rhs0 = tau - h - self.D * u
    vf = u + dt * dynamics.mv(invLt, dynamics.mv(invL, rhs0))
    u2 = solve.solve(J, W, vf, bias, mu, active, self.kinds)
    margin = torch.minimum(depth.abs().amin(1),
                           torch.minimum((qp - self.lim_hi).abs(),
                                         (qp - self.lim_lo).abs()).amin(1))
    return dynamics.integrate_q(T, q, u2, dt), u2, margin
