"""Contact-QP block solve sharded across ranks: the port's counterpart of
raisimlib_tpu/parallel/qp_shard.py.

One large scene's Delassus system (nc contact blocks, G (nc, 3, nc, 3)) is
row-sharded over a mesh axis: each rank owns nc / D contact blocks and their
coupling rows G_i:, and the solve iterates PROJECTED JACOBI, the parallel
form of the sequential Gauss-Seidel. Each iteration every rank

  1. all_gathers the impulses lam over the qp ranks (the only cross-rank
     traffic, nc * 3 numbers),
  2. forms its rows' coupling c_i + sum_{j != i} G_ij lam_j locally,
  3. runs the exact per-contact cone solve (ops/contact.cone_solve) on its
     own rows,
  4. under-relaxes: lam <- (1 - omega) lam + omega lam*.

With a dp axis the mesh is 2-D: worlds shard over dp, each world's contact
rows over qp.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from raisimlib_torch.ops import contact as ct


def _jacobi_rows(G_l, c0_l, mu_l, act_l, q, group, n_qp, iters, omega, config):
  """The rank's rows of B worlds: G_l (B, nc_l, 3, nc, 3), c0_l (B, nc_l,
  3), mu_l / act_l (B, nc_l); q its position on the qp axis."""
  B, nc_l = c0_l.shape[:2]
  nc = G_l.shape[3]
  rows = torch.arange(nc_l, device=G_l.device)
  Gii = G_l[:, rows, :, q * nc_l + rows, :]                   # (nc_l, B, 3, 3)
  Gii = Gii.transpose(0, 1).reshape(B * nc_l, 3, 3)
  Gf = G_l.reshape(B, nc_l * 3, nc * 3)
  mu_f, act = mu_l.reshape(-1), act_l.reshape(B * nc_l, 1)
  lam = torch.zeros_like(c0_l)
  for _ in range(iters):
    if n_qp > 1:
      parts = [torch.empty_like(lam) for _ in range(n_qp)]
      dist.all_gather(parts, lam.contiguous(), group=group)
      lam_full = torch.cat(parts, 1)                          # (B, nc, 3)
    else:
      lam_full = lam
    resid = (Gf @ lam_full.reshape(B, -1, 1)).reshape(B * nc_l, 3)
    lam_f = lam.reshape(B * nc_l, 3)
    ci = c0_l.reshape(B * nc_l, 3) + resid - (Gii @ lam_f[..., None])[..., 0]
    lam_star = ct.cone_solve(Gii, ci, mu_f, config) * act
    lam = ((1.0 - omega) * lam_f + omega * lam_star).reshape(B, nc_l, 3)
  return lam


def make_sharded_contact_solver(mesh, qp_axis: str = "qp", dp_axis: str | None = "dp",
                                iters: int = 64, omega: float = 0.7,
                                config: ct.SolverConfig = ct.SolverConfig()):
  """solve(G, c0, mu, active) -> lam with contact rows sharded over `qp_axis`.

  Without `dp_axis`: G (nc, 3, nc, 3), c0 (nc, 3), mu / active (nc,), one
  world whose rows split over the mesh. With `dp_axis`: a leading world
  batch, sharded over dp, while each world's rows shard over qp. Every rank
  of the mesh passes the same global arrays and gets the same global lam
  back (one all_gather at the end); each computes only its own rows. nc must
  be divisible by the qp axis size (pad with inactive rows otherwise)."""
  qp_size = mesh.axis_size(qp_axis)
  row_axis = 0 if dp_axis is None else 1

  def solve(G, c0, mu, active):
    nc = c0.shape[row_axis]
    if nc % qp_size:
      raise ValueError(
          f"contact row count nc={nc} must be divisible by the '{qp_axis}' mesh "
          f"axis size {qp_size}; pad with inactive rows (active=0, identity "
          f"diagonal) to the next multiple")
    if dp_axis is None:
      G, c0, mu, active = G[None], c0[None], mu[None], active[None]
    nc_l = nc // qp_size
    q = mesh.coordinate(qp_axis)
    rs = slice(q * nc_l, (q + 1) * nc_l)
    ws = slice(None)
    if dp_axis is not None:
      n_dp = mesh.axis_size(dp_axis)
      if c0.shape[0] % n_dp:
        raise ValueError(f"a batch of {c0.shape[0]} worlds does not divide the "
                         f"'{dp_axis}' axis's {n_dp} ranks")
      b = c0.shape[0] // n_dp
      d = mesh.coordinate(dp_axis)
      ws = slice(d * b, (d + 1) * b)
    lam = _jacobi_rows(G[ws, rs], c0[ws, rs], mu[ws, rs], active[ws, rs], q,
                       mesh.group(qp_axis), qp_size, iters, omega, config)
    if mesh.size > 1:
      parts = [torch.empty_like(lam) for _ in range(mesh.size)]
      dist.all_gather(parts, lam.contiguous(), group=mesh.group())
      # parts in the mesh's row-major rank order; rows by qp, worlds by dp
      grid = {}
      for i, part in enumerate(parts):
        at = np.unravel_index(i, mesh.shape)
        dpi = 0 if dp_axis is None else at[mesh.axis_names.index(dp_axis)]
        grid[dpi, at[mesh.axis_names.index(qp_axis)]] = part
      n_dp = 1 if dp_axis is None else mesh.axis_size(dp_axis)
      lam = torch.cat([torch.cat([grid[i, j] for j in range(qp_size)], 1)
                       for i in range(n_dp)], 0)
    return lam if dp_axis is not None else lam[0]

  return solve
