"""Hard-contact Coulomb friction solver: batched per-contact exact cone solve.

Counterpart of raisimlib_tpu/ops/contact.py (RaiSim's per-contact iteration
method, Hwangbo, Lee, Hutter, RA-L 2018). Per Gauss-Seidel sweep, each
contact's 3D impulse is solved exactly on its friction cone for

    min_{lam in K_mu}  E(lam) = 1/2 lam^T G_ii lam + lam^T c_i .

The cone-boundary case is a fixed angular grid, a parabolic fit and guarded
Newton steps on dE/dtheta. The JAX package takes dE/dtheta and d2E/dtheta2 by
`jax.grad`; here they are written out analytically (see `_curve_derivs`), so
the solve stays differentiable by autograd with the same derivatives.

Every function batches over a leading dimension B of worlds.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class SolverConfig:
  """Fixed trip counts. `row_kinds` ("cone" | "lin" | "bilateral" per row, ()
  = all cone) lets the kernel specialise its per-row update; the generic
  solver here is kind-agnostic (bilateral rows are flagged by mu > 1e6)."""

  sweeps: int = 12
  n_grid: int = 32
  n_newton: int = 2
  row_kinds: tuple = ()


def stick_solve(g, c):
  """lam = -Gii^{-1} c from the 6 unique entries g = (g00,g01,g02,g11,g12,g22)
  and c = (c0, c1, c2), by the cofactor inverse. Each entry is a tensor."""
  g00, g01, g02, g11, g12, g22 = g
  c0, c1, c2 = c
  k00 = g11 * g22 - g12 * g12
  k01 = g02 * g12 - g01 * g22
  k02 = g01 * g12 - g02 * g11
  k11 = g00 * g22 - g02 * g02
  k12 = g01 * g02 - g00 * g12
  k22 = g00 * g11 - g01 * g01
  det = g00 * k00 + g01 * k01 + g02 * k02
  inv_det = 1.0 / (det + 1e-20)
  return (-(k00 * c0 + k01 * c1 + k02 * c2) * inv_det,
          -(k01 * c0 + k11 * c1 + k12 * c2) * inv_det,
          -(k02 * c0 + k12 * c1 + k22 * c2) * inv_det)


def _curve(G, c, mu, theta, big):
  """E(theta) on the slip curve lam = s [mu cos, mu sin, 1], s = -c_n/(G d)_n.

  G: the 9 entries G[a][b], c: the 3 components, mu — each (B, 1); theta
  (B, K). Returns (E masked with `big`, s, d0, d1); d2 == 1."""
  d0 = mu * torch.cos(theta)
  d1 = mu * torch.sin(theta)
  gd = [G[a][0] * d0 + G[a][1] * d1 + G[a][2] for a in range(3)]
  den_ok = gd[2] > 1e-12
  s = -c[2] / torch.where(den_ok, gd[2], 1.0)
  feas = den_ok & (s > 0.0)
  s = torch.where(feas, s, 0.0)
  E = 0.5 * s * s * (d0 * gd[0] + d1 * gd[1] + gd[2]) + s * (d0 * c[0] + d1 * c[1] + c[2])
  return torch.where(feas, E, big), s, d0, d1


def _curve_derivs(G, c, mu, theta):
  """(dE/dtheta, d2E/dtheta2) of `_curve`'s masked E, analytically.

  With n = (G d)_2 and s = -c_2/n on feasible lanes (zero elsewhere, where the
  masked E is the constant `big`):
    q = d.Gd, p = d.c, E = q s^2/2 + p s
    E'  = s s' q + s^2 q'/2 + s' p + s p'
    E'' = (s'^2 + s s'') q + 2 s s' q' + s^2 q''/2 + s'' p + 2 s' p' + s p''
  where d' = mu(-sin, cos, 0) and d'' = mu(-cos, -sin, 0)."""
  ct_, st_ = torch.cos(theta), torch.sin(theta)
  d = (mu * ct_, mu * st_, 1.0)
  e = (-mu * st_, mu * ct_)                   # d'
  f = (-mu * ct_, -mu * st_)                  # d''

  def Gv(v, a):                               # (G v)_a
    out = G[a][0] * v[0] + G[a][1] * v[1]
    return out + G[a][2] if len(v) == 3 else out

  gd = [Gv(d, a) for a in range(3)]
  ge = [Gv(e, a) for a in range(3)]
  gf = [Gv(f, a) for a in range(3)]
  n, n1, n2 = gd[2], ge[2], gf[2]
  den_ok = n > 1e-12
  n = torch.where(den_ok, n, 1.0)
  c2 = c[2]
  s = -c2 / n
  feas = den_ok & (s > 0.0)
  s1 = c2 * n1 / (n * n)
  s2 = c2 * (n2 / (n * n) - 2.0 * n1 * n1 / (n * n * n))
  q = d[0] * gd[0] + d[1] * gd[1] + gd[2]
  q1 = e[0] * gd[0] + e[1] * gd[1] + d[0] * ge[0] + d[1] * ge[1] + ge[2]
  q2 = (f[0] * gd[0] + f[1] * gd[1] + 2.0 * (e[0] * ge[0] + e[1] * ge[1])
        + d[0] * gf[0] + d[1] * gf[1] + gf[2])
  p = d[0] * c[0] + d[1] * c[1] + c2
  p1 = e[0] * c[0] + e[1] * c[1]
  p2 = f[0] * c[0] + f[1] * c[1]
  dE = s * s1 * q + 0.5 * s * s * q1 + s1 * p + s * p1
  d2E = ((s1 * s1 + s * s2) * q + 2.0 * s * s1 * q1 + 0.5 * s * s * q2
         + s2 * p + 2.0 * s1 * p1 + s * p2)
  return torch.where(feas, dE, 0.0), torch.where(feas, d2E, 0.0)


def cone_solve(G, c, mu, config: SolverConfig = SolverConfig()):
  """Exact per-contact solve of the hard-contact complementarity conditions.

    open:  lam = 0,            v_n+ = c_n >= 0
    stick: v+ = 0,             lam = -G^-1 c strictly inside the cone
    slip:  v_n+ = 0 exactly,   lam on the cone boundary, theta minimising E

  G (B,3,3) Delassus block in the contact frame (t1, t2, n), c (B,3), mu (B,).
  Returns lam (B,3)."""
  dtype, dev = c.dtype, c.device
  big = 1e30
  Gs = [[G[:, a, b:b + 1] for b in range(3)] for a in range(3)]   # (B, 1) each
  cs = [c[:, a:a + 1] for a in range(3)]
  mu1 = mu[:, None]
  g6 = (Gs[0][0], Gs[0][1], Gs[0][2], Gs[1][1], Gs[1][2], Gs[2][2])
  ls0, ls1, ls2 = stick_solve(g6, cs)
  t_norm = torch.sqrt(ls0 * ls0 + ls1 * ls1 + 1e-20)
  stick_ok = ((ls2 > 0.0) & (t_norm <= mu1 * ls2)) | (mu1 > 1e6)
  open_ok = cs[2] >= 0.0
  lam_stick = torch.cat([ls0, ls1, ls2], 1)
  # without a graph to build, skip the slip search when no world slips (one
  # host read; the result is the same)
  if (not (torch.is_grad_enabled() and (G.requires_grad or c.requires_grad))
      and bool((stick_ok | open_ok).all())):
    return torch.where(stick_ok, lam_stick, torch.zeros_like(lam_stick))

  n = config.n_grid
  dtheta = 2.0 * math.pi / n
  thetas = torch.arange(n, dtype=dtype, device=dev) * dtheta
  E_grid = _curve(Gs, cs, mu1, thetas, big)[0]                    # (B, n)
  k = torch.argmin(E_grid, 1, keepdim=True)
  Em = E_grid.gather(1, (k - 1) % n)
  E0 = E_grid.gather(1, k)
  Ep = E_grid.gather(1, (k + 1) % n)
  denom = Em - 2.0 * E0 + Ep
  den_ok = denom.abs() > 1e-30
  off = torch.where(den_ok, 0.5 * (Em - Ep) / torch.where(den_ok, denom, 1.0), 0.0)
  theta = thetas[k] + off.clamp(-1.0, 1.0) * dtheta               # (B, 1)

  E_theta = _curve(Gs, cs, mu1, theta, big)[0]
  for _ in range(config.n_newton):
    g1, g2 = _curve_derivs(Gs, cs, mu1, theta)
    g2_ok = g2 > 1e-12
    step = torch.where(g2_ok, g1 / torch.where(g2_ok, g2, 1.0), 0.0)
    cand = theta - step.clamp(-dtheta, dtheta)
    E_cand = _curve(Gs, cs, mu1, cand, big)[0]
    better = E_cand <= E_theta               # keep a step only if E does not rise
    theta = torch.where(better, cand, theta)
    E_theta = torch.where(better, E_cand, E_theta)

  _, s_best, d0, d1 = _curve(Gs, cs, mu1, theta, big)
  any_feas = E_grid.min(1, keepdim=True).values < big
  s_safe = torch.where(any_feas, s_best, -cs[2] / (Gs[2][2] + 1e-20))
  lam_slip = torch.cat([torch.where(any_feas, s_safe * d0, 0.0),
                        torch.where(any_feas, s_safe * d1, 0.0), s_safe], 1)
  return torch.where(stick_ok, lam_stick,
                     torch.where(open_ok, torch.zeros_like(lam_slip), lam_slip))


def solve_contacts(G, c0, mu, active, lam0=None,
                   config: SolverConfig = SolverConfig()):
  """Masked Gauss-Seidel sweeps with exact per-contact cone solves.

  G (B, nc, 3, nc, 3) Delassus in contact frames, c0 (B, nc, 3) free velocity
  in contact frames (bias included), mu / active (B, nc). Returns lam (B, nc, 3).
  Rows are kept as a list so that the sweep stays differentiable by autograd.
  Without a graph to build, a row that is inactive in every world keeps its
  zero impulse without a solve (one host read of `active` per call); with
  one, every row is solved, so that lam stays connected to G and c0."""
  B, nc = c0.shape[:2]
  lam = (torch.zeros_like(c0) if lam0 is None else lam0 * active[..., None]).unbind(1)
  lam = list(lam)
  Gf = G.reshape(B, nc * 3, nc * 3)
  rows = range(nc)
  if not (torch.is_grad_enabled() and (G.requires_grad or c0.requires_grad)):
    rows = [i for i, a in enumerate((active != 0).any(0).tolist()) if a]
  for _ in range(config.sweeps):
    for i in rows:
      Gi = Gf[:, 3 * i:3 * i + 3]                          # (B, 3, 3nc)
      Gii = Gi[:, :, 3 * i:3 * i + 3]
      lam_f = torch.cat(lam, -1)
      ci = (c0[:, i] + (Gi @ lam_f.unsqueeze(-1)).squeeze(-1)
            - (Gii @ lam[i].unsqueeze(-1)).squeeze(-1))
      lam[i] = cone_solve(Gii, ci, mu[:, i], config) * active[:, i:i + 1]
  return torch.stack(lam, 1)
