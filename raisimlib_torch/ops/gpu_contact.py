"""Batched matrix-free contact-dynamics solve: CUDA kernel + plain twins.

Counterpart of raisimlib_tpu/ops/pallas_contact.py. Three functions compute

    u_new = vf + M^-1 J^T lam,   lam = GS-cone-solve(G = J M^-1 J^T, ...)

from the factors Jr (B,nc,3,nv) contact-frame row Jacobians, Wt (B,nc,3,nv)
rows of J M^-1, vf (B,nv), bias (B,nc,3), mu / active (B,nc):

  * `solve_dynamics_batch` — the public entry. On a CUDA tensor it launches
    the hand-written kernel csrc/mf_solve.cu (which replaces the TPU kernel
    `_mf_kernel`: `_build.MF_LANES` lanes of a warp per world, the world's
    rows staged in shared memory, with the lane-split cone solve of
    csrc/cone_solve.cuh, which replaces `_cone_solve_vec`) on the
    batch-first tensors as they are (`kernel_inputs`, `launch_kernel`,
    `block_shape`); on a CPU tensor it runs `_mf_plain`. It is a
    torch.autograd.Function whose backward differentiates `_mf_pure`, the
    same split as the JAX package's custom VJP.
  * `_mf_plain` — the kernel's algorithm in plain PyTorch (hoisted Gii,
    grid + two 5-point refinements + parabolic fit, the same wrap-around
    neighbours): the CPU path and the reference the kernel is held to.
  * `_mf_pure` — the differentiable reference: forms G and runs
    ops/contact.solve_contacts (grid + Newton).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from raisimlib_torch import _build
from raisimlib_torch.ops import contact as ct

_KIND_CODES = {"cone": 0, "lin": 1, "bilateral": 2}
_BIG = 3e38


# ---------------------------------------------------------------------------
# differentiable reference
# ---------------------------------------------------------------------------


def _mf_pure(Jr, Wt, vf, bias, mu, active, config: ct.SolverConfig = ct.SolverConfig()):
  """Form G = J M^-1 J^T and solve with ops/contact.solve_contacts."""
  B, nc, _, nv = Jr.shape
  Jf = Jr.reshape(B, nc * 3, nv)
  Wf = Wt.reshape(B, nc * 3, nv)
  G = (Jf @ Wf.transpose(-1, -2)).reshape(B, nc, 3, nc, 3)
  c0 = (Jf @ vf.unsqueeze(-1)).reshape(B, nc, 3) - bias
  lam = ct.solve_contacts(G, c0, mu, active, config=config)
  u_new = vf + (Wf.transpose(-1, -2) @ lam.reshape(B, nc * 3, 1)).squeeze(-1)
  return u_new, lam


# ---------------------------------------------------------------------------
# plain twin of the kernel
# ---------------------------------------------------------------------------


def _select_min(E, theta):
  """(B,K) -> first-match argmin theta, E there, and its circular neighbours,
  by the same one-hot reductions as the TPU kernel."""
  K = E.shape[1]
  iota = torch.arange(K, device=E.device)
  Emin = E.min(1, keepdim=True).values
  kmin = torch.where(E == Emin, iota, K).min(1, keepdim=True).values
  onehot = (iota == kmin).to(E.dtype)
  return ((onehot * theta).sum(1), (onehot * E).sum(1),
          (onehot * torch.roll(E, 1, 1)).sum(1),       # E[k-1]
          (onehot * torch.roll(E, K - 1, 1)).sum(1))   # E[k+1]


def _cone_solve_grid(g, c, mu, n_grid: int):
  """Plain twin of csrc/cone_solve.cuh: g the 6 unique Gii entries, c the 3
  velocity components, mu — each (B,). Returns (lam0, lam1, lam2)."""
  g00, g01, g02, g11, g12, g22 = g
  c0, c1, c2 = c
  dtype, dev = c0.dtype, c0.device
  ls0, ls1, ls2 = ct.stick_solve(g, c)
  t_norm = torch.sqrt(ls0 * ls0 + ls1 * ls1 + 1e-20)
  stick_ok = ((ls2 > 0.0) & (t_norm <= mu * ls2)) | (mu > 1e6)
  open_ok = c2 >= 0.0

  def curve(theta):
    d0 = mu[:, None] * torch.cos(theta)
    d1 = mu[:, None] * torch.sin(theta)
    gd0 = g00[:, None] * d0 + g01[:, None] * d1 + g02[:, None]
    gd1 = g01[:, None] * d0 + g11[:, None] * d1 + g12[:, None]
    gd2 = g02[:, None] * d0 + g12[:, None] * d1 + g22[:, None]
    den_ok = gd2 > 1e-12
    s = -c2[:, None] / torch.where(den_ok, gd2, torch.ones_like(gd2))
    feas = den_ok & (s > 0.0)
    s = torch.where(feas, s, torch.zeros_like(s))
    dgd = d0 * gd0 + d1 * gd1 + gd2
    dc = d0 * c0[:, None] + d1 * c1[:, None] + c2[:, None]
    E = 0.5 * s * s * dgd + s * dc
    return torch.where(feas, E, torch.full_like(E, _BIG)), s, d0, d1

  dtheta = 2.0 * math.pi / n_grid
  thetas = (torch.arange(n_grid, device=dev).to(dtype) * dtheta).expand(c0.shape[0], n_grid)
  E_grid = curve(thetas)[0]
  theta_b = _select_min(E_grid, thetas)[0]
  offs = torch.arange(5, device=dev).to(dtype) * 0.5 - 1.0
  span = 0.5 * dtheta
  for _ in range(2):
    th5 = theta_b[:, None] + offs * span
    theta_b, E0, Em, Ep = _select_min(curve(th5)[0], th5)
    span = span * 0.25
  h = span * 4.0 * 0.5
  denom = Em - 2.0 * E0 + Ep
  off = torch.where(denom.abs() > 1e-30, 0.5 * (Em - Ep) / (denom + 1e-30),
                    torch.zeros_like(denom))
  theta_b = theta_b + off.clamp(-1.0, 1.0) * h

  _, s_b, d0_b, d1_b = curve(theta_b[:, None])
  any_feas = E_grid.min(1).values < _BIG
  s_safe = torch.where(any_feas, s_b[:, 0], -c2 / (g22 + 1e-20))
  zero = torch.zeros_like(s_safe)
  l0 = torch.where(any_feas, s_safe * d0_b[:, 0], zero)
  l1 = torch.where(any_feas, s_safe * d1_b[:, 0], zero)
  return tuple(torch.where(stick_ok, ls, torch.where(open_ok, zero, l))
               for ls, l in ((ls0, l0), (ls1, l1), (ls2, s_safe)))


def _row_kinds(config: ct.SolverConfig, nc: int) -> tuple:
  kinds = config.row_kinds or ("cone",) * nc
  if len(kinds) != nc:
    raise ValueError(f"{len(kinds)} row kinds for {nc} solver rows")
  return kinds


def _mf_plain(Jr, Wt, vf, bias, mu, active, config: ct.SolverConfig = ct.SolverConfig()):
  """The kernel's algorithm in plain PyTorch, batch-first."""
  B, nc, _, nv = Jr.shape
  kinds = _row_kinds(config, nc)
  act = active.to(vf.dtype)

  def dot(a, b):
    return (a * b).sum(-1)

  zero = torch.zeros_like(vf[:, 0])
  gii, ci0 = [], []
  for i in range(nc):
    J, W = Jr[:, i], Wt[:, i]
    if kinds[i] == "lin":
      gii.append((None,) * 5 + (dot(J[:, 2], W[:, 2]),))
      ci0.append((None, None, dot(J[:, 2], vf) - bias[:, i, 2]))
    else:
      gii.append(tuple(dot(J[:, a], W[:, b]) for a, b in
                       ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))))
      ci0.append(tuple(dot(J[:, a], vf) - bias[:, i, a] for a in range(3)))

  lam = [[zero, zero, zero] for _ in range(nc)]
  z = torch.zeros_like(vf)
  for _ in range(config.sweeps):
    for i in range(nc):
      g, J, W, li = gii[i], Jr[:, i], Wt[:, i], lam[i]
      if kinds[i] == "lin":
        c2 = ci0[i][2] + dot(J[:, 2], z) - g[5] * li[2]
        ln2 = torch.clamp(-c2 / (g[5] + 1e-20), min=0.0) * act[:, i]
        z = z + W[:, 2] * (ln2 - li[2])[:, None]
        lam[i] = [zero, zero, ln2]
        continue
      gm = ((g[0], g[1], g[2]), (g[1], g[3], g[4]), (g[2], g[4], g[5]))
      c = tuple(ci0[i][a] + dot(J[:, a], z)
                - (gm[a][0] * li[0] + gm[a][1] * li[1] + gm[a][2] * li[2])
                for a in range(3))
      if kinds[i] == "bilateral":
        ln = ct.stick_solve(g, c)
      else:
        ln = _cone_solve_grid(g, c, mu[:, i], config.n_grid)
      la = [ln[a] * act[:, i] for a in range(3)]
      dz = W[:, 0] * (la[0] - li[0])[:, None]
      dz = dz + W[:, 1] * (la[1] - li[1])[:, None]
      dz = dz + W[:, 2] * (la[2] - li[2])[:, None]
      z = z + dz
      lam[i] = la
  return vf + z, torch.stack([torch.stack(l, -1) for l in lam], 1)


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------


def _used_rows(kinds: tuple) -> int:
  """Solver rows the kernel stages: 3 per cone or bilateral row, 1 per lin."""
  return sum(1 if k == "lin" else 3 for k in kinds)


def block_shape(nc: int, nv: int, kinds: tuple, n_grid: int):
  """(worlds per block, shared bytes per block) that csrc/mf_solve.cu
  launches at these shapes (its `mf_block`): a one-warp block of 32 //
  `_build.MF_LANES` worlds, or as many as fit 227 KB of shared memory (a
  partial warp); worlds 0 where one world does not fit. Loads the kernel."""
  nbytes = ctypes.c_int(0)
  wpb = _build.load("mf_solve").mf_solve_block(nc, nv, _used_rows(kinds), n_grid,
                                              ctypes.byref(nbytes))
  return wpb, nbytes.value


@functools.lru_cache(maxsize=None)
def _row_table(kinds: tuple, device: str) -> torch.Tensor:
  """The kernel's int32 row table (2 nc + nrow entries): the kinds' codes;
  each solver row's first slot among the staged rows (3 per cone or
  bilateral row, 1 per lin row: its third); and each staged row's row in
  the (nc, 3, nv) inputs."""
  slots, src = [], []
  for i, k in enumerate(kinds):
    slots.append(len(src))
    src.extend([3 * i + 2] if k == "lin" else [3 * i, 3 * i + 1, 3 * i + 2])
  return torch.tensor([_KIND_CODES[k] for k in kinds] + slots + src, dtype=torch.int32,
                      device=device)


def kernel_inputs(Jr, Wt, vf, bias, mu, active, config: ct.SolverConfig):
  """Check the public (batch-first) inputs and hand them to the kernel as
  they are: Jr, Wt (B, nc, 3, nv); vf (B, nv); bias (B, nc, 3); mu, active
  (B, nc), active as float32 (`.contiguous()` copies only a view that is
  not). Returns them with the row table (`_row_table`) on the same device."""
  B, nc, _, nv = Jr.shape
  dev = Jr.device
  shapes = {"Jr": (Jr, (B, nc, 3, nv)), "Wt": (Wt, (B, nc, 3, nv)),
            "vf": (vf, (B, nv)), "bias": (bias, (B, nc, 3)),
            "mu": (mu, (B, nc)), "active": (active, (B, nc))}
  for name, (x, shape) in shapes.items():
    if x.device != dev:
      raise ValueError(f"{name} is on {x.device}, Jr on {dev}")
    if tuple(x.shape) != shape:
      raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
    if x.dtype != torch.float32 and name != "active":
      raise TypeError(f"the CUDA solve takes float32 only; {name} is {x.dtype}")
  ins = [x.contiguous() for x in (Jr, Wt, vf, bias, mu)] + [
      active.to(torch.float32).contiguous()]
  return ins, _row_table(_row_kinds(config, nc), str(dev))


def launch_kernel(ins, rows, config: ct.SolverConfig):
  """Launch csrc/mf_solve.cu on the inputs from `kernel_inputs`; returns (u
  (B, nv), lam (B, nc, 3)), allocated here. Raises ValueError where one
  world's shared arrays do not fit a block."""
  B, nc, _, nv = ins[0].shape
  dev = ins[0].device
  if not all(x.is_contiguous() and x.is_cuda for x in ins):
    raise ValueError("kernel inputs must be contiguous CUDA tensors")
  kinds = _row_kinds(config, nc)
  u = torch.empty((B, nv), dtype=torch.float32, device=dev)
  lam = torch.empty((B, nc, 3), dtype=torch.float32, device=dev)
  rc = _build.load("mf_solve").mf_solve_launch(
      *(x.data_ptr() for x in ins), rows.data_ptr(), u.data_ptr(), lam.data_ptr(), B, nc, nv,
      _used_rows(kinds), config.sweeps, config.n_grid,
      torch.cuda.current_stream(dev).cuda_stream)
  if rc != 0:
    if block_shape(nc, nv, kinds, config.n_grid)[0] == 0:
      raise ValueError(f"nc={nc}, nv={nv}: one world of the solve does not fit a block's "
                       f"227 KB of shared memory")
    raise RuntimeError(f"mf_solve kernel launch failed: cudaError {rc}")
  solve_dynamics_batch.launches += 1
  return u, lam


class _MFSolve(torch.autograd.Function):

  @staticmethod
  def forward(ctx, Jr, Wt, vf, bias, mu, active, config):
    ctx.config = config
    ctx.save_for_backward(Jr, Wt, vf, bias, mu, active)
    if Jr.is_cuda:
      return launch_kernel(*kernel_inputs(Jr, Wt, vf, bias, mu, active, config), config)
    return _mf_plain(Jr, Wt, vf, bias, mu, active, config)

  @staticmethod
  def backward(ctx, du, dlam):
    inputs = [x.detach().requires_grad_(need)
              for x, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
    diff = [x for x in inputs if x.requires_grad]
    with torch.enable_grad():
      outs = _mf_pure(*inputs, ctx.config)
      grads = iter(torch.autograd.grad(outs, diff, (du, dlam), allow_unused=True))
    return tuple(next(grads) if x.requires_grad else None for x in inputs) + (None,)


def solve_dynamics_batch(Jr, Wt, vf, bias, mu, active,
                         config: ct.SolverConfig = ct.SolverConfig()):
  """Batched contact-dynamics solve -> (u_new (B, nv), lam (B, nc, 3)).

  CUDA tensors (float32) launch csrc/mf_solve.cu and count one launch in
  `solve_dynamics_batch.launches` (or raise ValueError, where one world's
  shared arrays do not fit a block: `block_shape`); CPU tensors run
  `_mf_plain`. Gradients go through `_mf_pure`."""
  return _MFSolve.apply(Jr, Wt, vf, bias, mu, active, config)


solve_dynamics_batch.launches = 0


def cone_solve_ops(n_grid: int = 32) -> int:
  """Operations of one exact cone solve (csrc/cone_solve.cuh), every
  arithmetic operation, comparison, select and transcendental counted as one:
  a curve evaluation is 38 (sin, cos, 12 for G d, 5 each for d.Gd, d.c and E,
  5 guards and selects, 2 for d), the grid adds 2 per point (theta, running
  minimum), the refinements 10 evaluations and 2 selections, and stick,
  parabola and final combination about 90. The solve does this work whatever
  the case, so the count depends on n_grid only."""
  curve = 38
  return n_grid * (curve + 2) + 10 * (curve + 1) + 20 + curve + 90


def mf_solve_cost(B: int, nc: int, nv: int, kinds: tuple, sweeps: int = 12,
                  n_grid: int = 32):
  """(bytes, operations) the solve needs at these shapes, for its bound.

  Bytes: each float32 input read once, each output written once. Operations,
  per world: the hoisted dots, then per sweep and row the three (or one, for
  lin) J.z dots and W updates, and for cone rows the full solve
  (`cone_solve_ops`)."""
  n_lin = sum(k == "lin" for k in kinds)
  n_bil = sum(k == "bilateral" for k in kinds)
  n_cone = nc - n_lin - n_bil
  cone = cone_solve_ops(n_grid)
  full_row = 3 * 2 * nv + 15 + 3 * 2 * nv + 6          # J.z, c, W update
  per_world = ((n_cone + n_bil) * (9 * 2 * nv + 3) + n_lin * (2 * 2 * nv + 1)
               + sweeps * ((n_cone + n_bil) * full_row + n_cone * cone + n_bil * 40
                           + n_lin * (2 * 2 * nv + 6))
               + nv)
  bytes_in = 4 * B * (2 * 3 * nc * nv + nv + 3 * nc + 2 * nc)
  bytes_out = 4 * B * (nv + 3 * nc)
  return bytes_in + bytes_out, B * per_world
