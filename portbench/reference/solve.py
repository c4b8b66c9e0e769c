"""The contact solve: Gauss-Seidel sweeps over the contact cones (the exact
per-contact Coulomb-cone solve) and the joint-limit rows.

A frozen copy of the system's matrix-free algorithm, the one its kernels
implement: the hoisted 3x3 block of each cone, a stick solve, and where the
stick impulse leaves the cone, a slip search over a 32-point angular grid,
two 5-point refinements and a parabolic fit. A limit row is a clamped scalar
update. The solve works on the rows J and W = J M^-1, never on G itself.
"""

from __future__ import annotations

import math

import torch

BIG = 3e38


def stick_solve(g, c):
  """-Gii^-1 c by the cofactor inverse; g the 6 unique entries of Gii."""
  g00, g01, g02, g11, g12, g22 = g
  c0, c1, c2 = c
  k00, k01, k02 = g11 * g22 - g12 * g12, g02 * g12 - g01 * g22, g01 * g12 - g02 * g11
  k11, k12, k22 = g00 * g22 - g02 * g02, g01 * g02 - g00 * g12, g00 * g11 - g01 * g01
  inv = 1.0 / (g00 * k00 + g01 * k01 + g02 * k02 + 1e-20)
  return (-(k00 * c0 + k01 * c1 + k02 * c2) * inv, -(k01 * c0 + k11 * c1 + k12 * c2) * inv,
          -(k02 * c0 + k12 * c1 + k22 * c2) * inv)


def _select_min(E, theta):
  """First-match argmin over the last axis: theta there, E there, and E at
  its two circular neighbours."""
  K = E.shape[1]
  iota = torch.arange(K, device=E.device)
  kmin = torch.where(E == E.min(1, keepdim=True).values, iota, K).min(1, keepdim=True).values
  hot = (iota == kmin).to(E.dtype)
  return ((hot * theta).sum(1), (hot * E).sum(1), (hot * torch.roll(E, 1, 1)).sum(1),
          (hot * torch.roll(E, K - 1, 1)).sum(1))


def cone_solve(g, c, mu, n_grid: int):
  """The impulse (l0, l1, l2) of one contact in its frame (t1, t2, n)."""
  g00, g01, g02, g11, g12, g22 = g
  c0, c1, c2 = c
  ls = stick_solve(g, c)
  stick_ok = (((ls[2] > 0.0) & (torch.sqrt(ls[0] * ls[0] + ls[1] * ls[1] + 1e-20)
                                <= mu * ls[2])) | (mu > 1e6))
  open_ok = c2 >= 0.0

  def curve(theta):
    d0, d1 = mu[:, None] * torch.cos(theta), mu[:, None] * torch.sin(theta)
    gd0 = g00[:, None] * d0 + g01[:, None] * d1 + g02[:, None]
    gd1 = g01[:, None] * d0 + g11[:, None] * d1 + g12[:, None]
    gd2 = g02[:, None] * d0 + g12[:, None] * d1 + g22[:, None]
    den_ok = gd2 > 1e-12
    s = -c2[:, None] / torch.where(den_ok, gd2, torch.ones_like(gd2))
    feas = den_ok & (s > 0.0)
    s = torch.where(feas, s, torch.zeros_like(s))
    E = (0.5 * s * s * (d0 * gd0 + d1 * gd1 + gd2)
         + s * (d0 * c0[:, None] + d1 * c1[:, None] + c2[:, None]))
    return torch.where(feas, E, torch.full_like(E, BIG)), s, d0, d1

  dth = 2.0 * math.pi / n_grid
  thetas = (torch.arange(n_grid, device=c0.device).to(c0.dtype) * dth).expand(c0.shape[0], -1)
  E_grid = curve(thetas)[0]
  th = _select_min(E_grid, thetas)[0]
  offs = torch.arange(5, device=c0.device).to(c0.dtype) * 0.5 - 1.0
  span = 0.5 * dth
  for _ in range(2):
    th5 = th[:, None] + offs * span
    th, E0, Em, Ep = _select_min(curve(th5)[0], th5)
    span = span * 0.25
  den = Em - 2.0 * E0 + Ep
  off = torch.where(den.abs() > 1e-30, 0.5 * (Em - Ep) / (den + 1e-30), torch.zeros_like(den))
  th = th + off.clamp(-1.0, 1.0) * (span * 2.0)
  _, s, d0, d1 = curve(th[:, None])
  feas = E_grid.min(1).values < BIG
  s = torch.where(feas, s[:, 0], -c2 / (g22 + 1e-20))
  zero = torch.zeros_like(s)
  slip = (torch.where(feas, s * d0[:, 0], zero), torch.where(feas, s * d1[:, 0], zero), s)
  return tuple(torch.where(stick_ok, a, torch.where(open_ok, zero, b))
               for a, b in zip(ls, slip))


def solve(J, W, vf, bias, mu, active, kinds, sweeps: int = 12, n_grid: int = 32):
  """u' = vf + sum_i W_i^T lam_i after `sweeps` Gauss-Seidel sweeps over the
  rows in order. J, W (B, n, 3, nv) in the rows' frames, vf (B, nv), bias
  (B, n, 3), mu and active (B, n); kinds[i] "cone" or "lin"."""
  n = J.shape[1]
  act = active.to(vf.dtype)

  def dot(a, b):
    return (a * b).sum(-1)

  zero = torch.zeros_like(vf[:, 0])
  gii, c0 = [], []
  for i in range(n):
    if kinds[i] == "lin":
      gii.append((None,) * 5 + (dot(J[:, i, 2], W[:, i, 2]),))
      c0.append((None, None, dot(J[:, i, 2], vf) - bias[:, i, 2]))
    else:
      gii.append(tuple(dot(J[:, i, a], W[:, i, b]) for a, b in
                       ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))))
      c0.append(tuple(dot(J[:, i, a], vf) - bias[:, i, a] for a in range(3)))
  lam = [[zero, zero, zero] for _ in range(n)]
  z = torch.zeros_like(vf)
  for _ in range(sweeps):
    for i in range(n):
      g, Ji, Wi, li = gii[i], J[:, i], W[:, i], lam[i]
      if kinds[i] == "lin":
        c2 = c0[i][2] + dot(Ji[:, 2], z) - g[5] * li[2]
        l2 = torch.clamp(-c2 / (g[5] + 1e-20), min=0.0) * act[:, i]
        z = z + Wi[:, 2] * (l2 - li[2])[:, None]
        lam[i] = [zero, zero, l2]
        continue
      gm = ((g[0], g[1], g[2]), (g[1], g[3], g[4]), (g[2], g[4], g[5]))
      c = tuple(c0[i][a] + dot(Ji[:, a], z)
                - (gm[a][0] * li[0] + gm[a][1] * li[1] + gm[a][2] * li[2]) for a in range(3))
      la = [x * act[:, i] for x in cone_solve(g, c, mu[:, i], n_grid)]
      z = z + (Wi[:, 0] * (la[0] - li[0])[:, None] + Wi[:, 1] * (la[1] - li[1])[:, None]
               + Wi[:, 2] * (la[2] - li[2])[:, None])
      lam[i] = la
  return vf + z
