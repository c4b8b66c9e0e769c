"""Multiple-shooting horizon decomposition across ranks: the port's
counterpart of raisimlib_tpu/parallel/multishoot.py.

The horizon H = S L is split into S segments, segment k on the mesh's rank
k. Each outer round every rank solves an iLQR subproblem on its segment
whose terminal cost pulls its end state toward the next segment's knot (the
last segment owns the true final cost); the segment end states travel one
rank forward on a send/recv ring; the knots relax toward them; the new knots
travel one rank back as the next consensus targets; the consensus weight
grows. The ring exchanges are `dist.batch_isend_irecv` pairs, so no rank
waits on its own send (S = 2 included). The warm start and the stitch
all_gather the controls; the knot defects reduce with a max.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch
import torch.distributed as dist

from raisimlib_torch.mpc.ilqr import ILQRConfig, ilqr


@dataclasses.dataclass(frozen=True)
class MultiShootConfig:
  outer_iters: int = 6
  ilqr: ILQRConfig = ILQRConfig(iters=8)
  rho: float = 10.0              # consensus penalty weight
  rho_growth: float = 1.6        # per-outer-round penalty escalation
  knot_relax: float = 1.0        # 1.0 = pure Gauss-Jacobi shooting update


class MultiShootSolution(NamedTuple):
  U: torch.Tensor             # (H, nu) stitched control plan (on every rank)
  knots: torch.Tensor         # (S, nx) final knot states
  cost: torch.Tensor          # true cost of the stitched sequential rollout
  defect_trace: torch.Tensor  # (outer_iters,) max knot defect norm per round


def _rollout(dyn, x, U, t0=0):
  """States x_0 .. x_L of a plan U (L, nu) from x (nx,): (L + 1, nx)."""
  xs = [x[None]]
  for t in range(U.shape[0]):
    xs.append(dyn(xs[-1], U[t][None], t + t0))
  return torch.cat(xs, 0)


def _seq_cost(dyn, running_cost, final_cost, x0, U):
  X = _rollout(dyn, x0, U)
  H = U.shape[0]
  ts = torch.arange(H, device=U.device)
  return running_cost(X[:-1], U, ts).sum() + final_cost(X[-1:])[0]


def multishoot_solve(dyn: Callable, running_cost: Callable, final_cost: Callable,
                     x0: torch.Tensor, U0: torch.Tensor, mesh,
                     config: MultiShootConfig = MultiShootConfig()) -> MultiShootSolution:
  """Consensus multiple-shooting MPC over a 1-D mesh, one segment a rank.

  Batched dynamics and costs, as the port's `ilqr` takes them. Every rank
  passes the same x0 (nx,) and U0 (H, nu), H divisible by the mesh size,
  and gets the same solution back."""
  if len(mesh.axis_names) != 1:
    raise ValueError(f"multishoot_solve needs a 1-D mesh, not axes {mesh.axis_names}")
  S = mesh.size
  H, nu = U0.shape
  if H % S:
    raise ValueError(f"horizon {H} not divisible by {S} segments")
  L = H // S
  k = mesh.index()
  group = mesh.group()
  ranks = mesh.devices.reshape(-1).tolist()
  t0 = k * L
  is_first, is_last = k == 0, k == S - 1

  def shift(x, forward: bool):
    """Ring shift of x by one rank: forward, rank k gets rank k - 1's;
    back, rank k gets rank k + 1's."""
    if S == 1:
      return x
    dst, src = (k + 1) % S, (k - 1) % S
    if not forward:
      dst, src = src, dst
    out = torch.empty_like(x)
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, x.contiguous(), ranks[dst], group),
                                   dist.P2POp(dist.irecv, out, ranks[src], group)])
    for r in reqs:
      r.wait()
    return out

  def gather_rows(x):
    if S == 1:
      return x
    parts = [torch.empty_like(x) for _ in range(S)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, 0)

  def dyn_seg(X, U, t):
    return dyn(X, U, t + t0)

  def rc_seg(X, U, t):
    return running_cost(X, U, t + t0)

  U_all0 = gather_rows(U0[t0:t0 + L])                         # (H, nu)
  with torch.no_grad():
    X_warm = _rollout(dyn, x0, U_all0)
  xknot = X_warm[t0]
  xnext = shift(xknot, forward=False)
  U, rho = U0[t0:t0 + L], float(config.rho)
  defects = []
  for _ in range(config.outer_iters):
    def fc_seg(X, xnext=xnext, rho=rho):
      if is_last:
        return final_cost(X)
      return 0.5 * rho * ((X - xnext) ** 2).sum(-1)

    sol = ilqr(dyn_seg, rc_seg, fc_seg, xknot, U, config.ilqr)
    with torch.no_grad():
      x_end = _rollout(dyn_seg, xknot, sol.U)[-1]
    x_in = shift(x_end, forward=True)
    defect = (torch.zeros((), dtype=x0.dtype, device=x0.device) if is_first
              else torch.sqrt(((x_in - xknot) ** 2).sum()))
    if S > 1:
      dist.all_reduce(defect, op=dist.ReduceOp.MAX, group=group)
    defects.append(defect)
    if not is_first:
      xknot = (1.0 - config.knot_relax) * xknot + config.knot_relax * x_in
    xnext = shift(xknot, forward=False)
    U, rho = sol.U, rho * config.rho_growth

  U_full = gather_rows(U)
  with torch.no_grad():
    cost = _seq_cost(dyn, running_cost, final_cost, x0, U_full)
  return MultiShootSolution(U=U_full, knots=gather_rows(xknot[None]), cost=cost,
                            defect_trace=torch.stack(defects))
