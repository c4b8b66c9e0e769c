"""iLQR/DDP shooting optimiser with every physics evaluation in one batch.

Counterpart of raisimlib_tpu/mpc/ilqr.py (ILQRConfig, ILQRSolution,
batched_dyn_jacobians, batched_dyn_jacobians_fd, ilqr_batch, ilqr). E
independent problems share each phase's physics batch:

  * the nominal rollout runs `dyn_fast` at batch E, and the line search runs
    the whole ladder of n_alpha step sizes at batch E * n_alpha, one call a
    time step;
  * the (E * H) per-timestep dynamics Jacobians come from one forward-mode
    pass through `dyn_diff` at nd * E * H rows, nd = nx + nu, one basis
    tangent per block of rows (`deriv="jvp"`), or from one call of
    `dyn_fast` on the perturbed rows (`deriv="fd"`): on a contact scene on
    the card that is one launch of the fused step K1;
  * the cost derivatives come from torch.func over a one-row wrapper of the
    batched costs, vmapped over rows;
  * the Riccati pass is a reversed loop over H on (E, ., .) matrices.

Each phase of a solve runs in a span of utils/profiling.py (`ilqr.rollout`,
`ilqr.dynamics_jacobians`, `ilqr.cost_derivatives`, `ilqr.riccati`,
`ilqr.line_search`), a torch.profiler range of that name when the profiler
records, which tools/profile_ilqr.py reads.

Costs are batched, as the port's MPPI takes them:
`running_cost(X (N, nx), U (N, nu), t (N,)) -> (N,)` and
`final_cost(X (N, nx)) -> (N,)`. The rollouts, the finite differences and the
line search run under torch.no_grad(): a kernel's autograd Function would
otherwise keep its inputs for a backward that nobody calls.

Where the JAX package's `ilqr_batch` falls back to finite differences when
`dyn_diff` is None, even with `deriv="jvp"`, this one raises ValueError.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch
import torch.autograd.forward_ad as fwAD

from raisimlib_torch.utils import profiling

DERIV_PATHS = ("jvp", "fd")


@dataclasses.dataclass(frozen=True)
class ILQRConfig:
  iters: int = 30
  n_alpha: int = 8
  # dynamics-Jacobian path of ilqr_batch: "jvp" pushes basis tangents through
  # the differentiable `dyn_diff` (exact); "fd" differences `dyn_fast` itself
  # (the kernel path). fd_eps is large on purpose: through the float32
  # hard-contact step a small eps leaves difference noise that the Riccati
  # pass amplifies until the line search rejects every step; eps in
  # [1e-2, 5e-2] gives smoothed Jacobians across contact-mode boundaries.
  deriv: str = "jvp"
  fd_eps: float = 2e-2
  # 2: central differences, 2 (nx + nu) rows per row; 1: forward
  # differences, nx + nu + 1 rows per row (half the rows, O(eps) truncation)
  fd_order: int = 2
  reg_init: float = 1e-6
  reg_min: float = 1e-9
  reg_max: float = 1e8
  reg_up: float = 8.0
  reg_down: float = 0.5
  # accept a step if the cost falls by more than this
  accept_tol: float = 0.0


class ILQRSolution(NamedTuple):
  X: torch.Tensor           # (E, H+1, nx) optimal state trajectories
  U: torch.Tensor           # (E, H, nu) optimal controls
  cost: torch.Tensor        # (E,) final costs
  cost_trace: torch.Tensor  # (E, iters) cost after each iteration
  reg_trace: torch.Tensor   # (E, iters)
  gains_K: torch.Tensor     # (E, H, nu, nx) feedback gains of the last accepted pass


def batched_dyn_jacobians(dyn_diff: Callable, X, U, t=0):
  """Per-row Jacobians fx (B, nx, nx), fu (B, nx, nu) of a row-wise batched
  dynamics `dyn_diff(X (B, nx), U (B, nu), t) -> (B, nx)`, exact, by one
  forward-mode pass at nd * B rows (nd = nx + nu): row block j holds X, U
  with the basis tangent e_j, so its output tangent is every row's column j.
  `dyn_diff` must support forward-mode AD (make_contact_dyn_batch(...,
  use_kernel=False), make_smooth_dyn); the fused kernel does not."""
  B, nx = X.shape
  nu = U.shape[1]
  nd = nx + nu
  eye = torch.eye(nd, dtype=X.dtype, device=X.device)[:, None, :].expand(nd, B, nd)
  tX = eye[..., :nx].reshape(nd * B, nx)
  tU = eye[..., nx:].reshape(nd * B, nu)
  with fwAD.dual_level():
    out = dyn_diff(fwAD.make_dual(X.repeat(nd, 1), tX), fwAD.make_dual(U.repeat(nd, 1), tU), t)
    J = fwAD.unpack_dual(out).tangent
  if J is None:                                 # the output does not depend on X, U
    J = torch.zeros((nd * B, nx), dtype=X.dtype, device=X.device)
  J = J.reshape(nd, B, nx)
  return J[:nx].permute(1, 2, 0), J[nx:].permute(1, 2, 0)


def fd_rows(X, U, eps, order=2):
  """The rows that batched_dyn_jacobians_fd steps, direction-major then row
  as the JAX package lays them out: X + eps e_j (j over the nd = nx + nu
  directions of [x, u]) then X - eps e_j (`order=2`, 2 nd B rows) or X
  itself (`order=1`, (nd + 1) B rows). Returns (Xs, Us)."""
  B, nx = X.shape
  nu = U.shape[1]
  nd = nx + nu
  dtype, dev = X.dtype, X.device
  dX = torch.cat([torch.eye(nx, dtype=dtype, device=dev) * eps,
                  torch.zeros((nu, nx), dtype=dtype, device=dev)], 0)
  dU = torch.cat([torch.zeros((nx, nu), dtype=dtype, device=dev),
                  torch.eye(nu, dtype=dtype, device=dev) * eps], 0)
  Xp = (X[None] + dX[:, None]).reshape(nd * B, nx)
  Up = (U[None] + dU[:, None]).reshape(nd * B, nu)
  if order == 2:
    return (torch.cat([Xp, (X[None] - dX[:, None]).reshape(nd * B, nx)], 0),
            torch.cat([Up, (U[None] - dU[:, None]).reshape(nd * B, nu)], 0))
  if order == 1:
    return torch.cat([Xp, X], 0), torch.cat([Up, U], 0)
  raise ValueError(f"fd order {order}: expected 1 or 2")


def batched_dyn_jacobians_fd(dyn_fast: Callable, X, U, t=0, eps=1e-3, order=2):
  """Per-row Jacobians (fx, fu) by finite differences through `dyn_fast`:
  one call on the rows of `fd_rows`, central (`order=2`) or forward
  (`order=1`). `dyn_fast` must be time-invariant: every row shares one t."""
  B, nx = X.shape
  nd = nx + U.shape[1]
  Y = dyn_fast(*fd_rows(X, U, eps, order), t)
  if order == 2:
    J = (Y[:nd * B] - Y[nd * B:]).reshape(nd, B, nx) / (2.0 * eps)
  else:
    J = (Y[:nd * B].reshape(nd, B, nx) - Y[nd * B:][None]) / eps
  return J[:nx].permute(1, 2, 0), J[nx:].permute(1, 2, 0)


def _cost_derivatives(running_cost, final_cost, nx):
  """Row-wise derivative functions: the running cost's gradient (N, nz) and
  Hessian (N, nz, nz) in z = [x, u] (cx, cu; cxx, cuu, cux are its blocks)
  on rows Z (N, nz) at t (N,), and the final cost's gradient and Hessian on
  rows X (N, nx): torch.func over one-row wrappers of the batched costs,
  vmapped over rows."""
  from torch import func

  def rc1(z, t):
    return running_cost(z[None, :nx], z[None, nx:], t[None])[0]

  def fc1(x):
    return final_cost(x[None])[0]

  return (func.vmap(func.grad(rc1)), func.vmap(func.hessian(rc1)),
          func.vmap(func.grad(fc1)), func.vmap(func.hessian(fc1)))


def _riccati(fx, fu, cz, czz, Vx, Vxx, reg, nx):
  """The backward pass of E problems at once: fx (E, H, nx, nx), fu (E, H,
  nx, nu), cz (E, H, nz) and czz (E, H, nz, nz) the running cost's gradient
  and Hessian in z = [x, u], Vx (E, nx), Vxx (E, nx, nx) the final cost's,
  reg (E,). Returns ks (E, H, nu), Ks (E, H, nu, nx) and ok (E,): every
  Quu + reg I positive definite. Where one is not (a failed or non-finite
  Cholesky factor), that step's gains are zero, as in the JAX package."""
  E, H, _, nu = fu.shape
  eye = torch.eye(nu, dtype=fx.dtype, device=fx.device)
  ok = torch.ones(E, dtype=torch.bool, device=fx.device)
  ks, Ks = [None] * H, [None] * H

  def mv(A, x):
    return (A @ x.unsqueeze(-1)).squeeze(-1)

  for t in range(H - 1, -1, -1):
    fxT, fuT = fx[:, t].transpose(-1, -2), fu[:, t].transpose(-1, -2)
    Qx = cz[:, t, :nx] + mv(fxT, Vx)
    Qu = cz[:, t, nx:] + mv(fuT, Vx)
    Qxx = czz[:, t, :nx, :nx] + fxT @ Vxx @ fx[:, t]
    Quu = czz[:, t, nx:, nx:] + fuT @ Vxx @ fu[:, t]
    Qux = czz[:, t, nx:, :nx] + fuT @ Vxx @ fx[:, t]
    L, info = torch.linalg.cholesky_ex(Quu + reg[:, None, None] * eye)
    pd = (info == 0) & torch.isfinite(L).flatten(1).all(1)
    sol = torch.cholesky_solve(torch.cat([Qu.unsqueeze(-1), Qux], -1), L)
    sol = torch.where(pd[:, None, None], sol, torch.zeros_like(sol))
    k, K = -sol[..., 0], -sol[..., 1:]
    KT, QuxT = K.transpose(-1, -2), Qux.transpose(-1, -2)
    Vx = Qx + mv(KT @ Quu, k) + mv(KT, Qu) + mv(QuxT, k)
    Vxx = Qxx + KT @ Quu @ K + KT @ Qux + QuxT @ K
    Vxx = 0.5 * (Vxx + Vxx.transpose(-1, -2))
    ok = ok & pd
    ks[t], Ks[t] = k, K
  return torch.stack(ks, 1), torch.stack(Ks, 1), ok


def ilqr_batch(
    dyn_fast: Callable,             # (X (B, nx), U (B, nu), t) -> (B, nx); forward only
    dyn_diff: Optional[Callable],   # the same map, forward-differentiable; for deriv="jvp"
    running_cost: Callable,         # (X (N, nx), U (N, nu), t (N,)) -> (N,)
    final_cost: Callable,           # (X (N, nx)) -> (N,)
    x0s: torch.Tensor,              # (E, nx)
    U0s: torch.Tensor,              # (E, H, nu)
    config: ILQRConfig = ILQRConfig(),
) -> ILQRSolution:
  """E independent fixed-iteration iLQR solves whose physics runs as one
  batch per phase (see the module docstring). The derivative stack
  evaluates every time step at t = 0: the dynamics must be time-invariant.
  Raises ValueError for an unknown `config.deriv`, and for "jvp" without a
  `dyn_diff`. Returns an ILQRSolution with a leading E axis on every field."""
  if config.deriv not in DERIV_PATHS:
    raise ValueError(f"unknown deriv path {config.deriv!r}: expected one of {DERIV_PATHS}")
  if config.deriv == "jvp" and dyn_diff is None:
    raise ValueError("deriv='jvp' needs a forward-differentiable dyn_diff; pass one, or "
                     "ILQRConfig(deriv='fd') for finite differences through dyn_fast")
  E, H, nu = U0s.shape
  nx = x0s.shape[1]
  dtype, dev = x0s.dtype, x0s.device
  nA = config.n_alpha
  # the ladder in float32, then cast, as the JAX package computes it
  alphas = (1.1 ** (-(torch.arange(nA, dtype=torch.float32) ** 2))).to(dtype=dtype, device=dev)
  aexp = alphas.repeat(E)                                         # (E * nA,)
  ts = torch.arange(H, device=dev)
  cz_fn, czz_fn, vx_fn, vxx_fn = _cost_derivatives(running_cost, final_cost, nx)

  def traj_cost(X, U):
    N = X.shape[0]
    cs = running_cost(X[:, :-1].reshape(N * H, nx), U.reshape(N * H, nu), ts.repeat(N))
    return cs.reshape(N, H).sum(1) + final_cost(X[:, -1])

  def rollout(x, U):
    xs = [x]
    for t in range(H):
      xs.append(dyn_fast(xs[-1], U[:, t], t))
    return torch.stack(xs, 1)

  def line_search(X, U, ks, Ks):
    """Every env's n_alpha candidates in one physics batch of E * n_alpha."""
    Xr, Ur = X.repeat_interleave(nA, 0), U.repeat_interleave(nA, 0)
    kr, Kr = ks.repeat_interleave(nA, 0), Ks.repeat_interleave(nA, 0)
    xs, us = [Xr[:, 0]], []
    for t in range(H):
      dx = (xs[-1] - Xr[:, t]).unsqueeze(-1)
      us.append(Ur[:, t] + aexp[:, None] * kr[:, t] + (Kr[:, t] @ dx).squeeze(-1))
      xs.append(dyn_fast(xs[-1], us[-1], t))
    Xc, Uc = torch.stack(xs, 1), torch.stack(us, 1)
    costs = traj_cost(Xc, Uc)
    return Xc.reshape(E, nA, H + 1, nx), Uc.reshape(E, nA, H, nu), costs.reshape(E, nA)

  with torch.no_grad(), profiling.span("ilqr.rollout"):
    X = rollout(x0s, U0s)
    cost = traj_cost(X, U0s)
  U = U0s
  reg = torch.full((E,), config.reg_init, dtype=dtype, device=dev)
  K_last = torch.zeros((E, H, nu, nx), dtype=dtype, device=dev)
  ctrace = torch.empty((E, config.iters), dtype=dtype, device=dev)
  rtrace = torch.empty_like(ctrace)
  rows = torch.arange(E, device=dev)
  for it in range(config.iters):
    Xf, Uf = X[:, :-1].reshape(E * H, nx), U.reshape(E * H, nu)
    with profiling.span("ilqr.dynamics_jacobians"):
      if config.deriv == "fd":
        with torch.no_grad():
          fx, fu = batched_dyn_jacobians_fd(dyn_fast, Xf, Uf, 0, config.fd_eps,
                                            config.fd_order)
      else:
        fx, fu = batched_dyn_jacobians(dyn_diff, Xf, Uf, 0)
    with profiling.span("ilqr.cost_derivatives"):
      Zf, tf = torch.cat([Xf, Uf], 1), ts.repeat(E)
      cz = cz_fn(Zf, tf).reshape(E, H, nx + nu)
      czz = czz_fn(Zf, tf).reshape(E, H, nx + nu, nx + nu)
      Vx, Vxx = vx_fn(X[:, -1]), vxx_fn(X[:, -1])
    with profiling.span("ilqr.riccati"):
      ks, Ks, ok = _riccati(fx.reshape(E, H, nx, nx), fu.reshape(E, H, nx, nu), cz, czz,
                            Vx, Vxx, reg, nx)
    with torch.no_grad(), profiling.span("ilqr.line_search"):
      Xs, Us, costs = line_search(X, U, ks, Ks)
    best = torch.argmin(costs, 1)          # the first minimum; a NaN candidate wins, and
    cbest = costs[rows, best]              # then fails the finiteness test below
    improved = ok & (cbest < cost - config.accept_tol) & torch.isfinite(cbest)
    X = torch.where(improved[:, None, None], Xs[rows, best], X)
    U = torch.where(improved[:, None, None], Us[rows, best], U)
    cost = torch.where(improved, cbest, cost)
    K_last = torch.where(improved[:, None, None, None], Ks, K_last)
    reg = torch.where(improved, torch.clamp(reg * config.reg_down, min=config.reg_min),
                      torch.clamp(reg * config.reg_up, max=config.reg_max))
    ctrace[:, it], rtrace[:, it] = cost, reg
  return ILQRSolution(X=X, U=U, cost=cost, cost_trace=ctrace, reg_trace=rtrace, gains_K=K_last)


def ilqr(
    dyn: Callable,             # (X (B, nx), U (B, nu), t) -> (B, nx)
    running_cost: Callable,    # (X (N, nx), U (N, nu), t (N,)) -> (N,)
    final_cost: Callable,      # (X (N, nx)) -> (N,)
    x0: torch.Tensor,          # (nx,)
    U0: torch.Tensor,          # (H, nu)
    config: ILQRConfig = ILQRConfig(),
) -> ILQRSolution:
  """One fixed-iteration iLQR solve: `ilqr_batch` at E = 1 with
  `dyn_diff = dyn`, so that the Jacobians are exact (with the default
  deriv="jvp") where the JAX package's `ilqr` takes jacfwd per time step;
  the algorithm and the schedule are the same. Returns an ILQRSolution
  without the E axis."""
  sol = ilqr_batch(dyn, dyn, running_cost, final_cost, x0[None], U0[None], config)
  return ILQRSolution(*(x[0] for x in sol))
