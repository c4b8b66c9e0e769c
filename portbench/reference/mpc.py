"""The MPPI update and the two controllers' costs, in plain PyTorch.

`update` is the system's sampling update written out: the white noise
low-pass coloured and variance-normalised, sample 0 left unperturbed, each
sample's cost, the weights exp(-(c - min c) / T) and their average. The
costs are the balance and trot examples' (height, orientation, velocities,
posture and effort; on terrain the height over the local surface).
"""

from __future__ import annotations

import torch

from portbench.reference.collide import surface_at
from portbench.reference.dynamics import quat_box_minus
from portbench.reference.model import standing_q


def colorize(eps, smooth: float):
  """(..., H, nu) white noise -> coloured, with the white noise's variance."""
  prev = torch.zeros_like(eps[..., 0, :])
  out = []
  for k in range(eps.shape[-2]):
    prev = smooth * prev + (1.0 - smooth) * eps[..., k, :]
    out.append(prev)
  return torch.stack(out, -2) / ((1.0 - smooth) / (1.0 + smooth) + 1e-9) ** 0.5


def samples(U, eps, smooth: float):
  """(E, K, H, nu) sampled plans around U (E, H, nu); sample 0 is U itself."""
  e = colorize(eps, smooth)
  e[:, 0] = 0.0
  return U[:, None] + e


def update(U, eps, costs, smooth: float, temperature: float):
  """The weighted average of the sampled plans by their costs (E, K)."""
  Us = samples(U, eps, smooth)
  w = torch.exp(-(costs - costs.min(1, keepdim=True).values) / temperature)
  return torch.einsum("ek,ekhu->ehu", w / w.sum(1, keepdim=True), Us)


def _ident(x):
  """The identity quaternion, made on x's device without a host copy."""
  e = torch.zeros(4, dtype=x.dtype, device=x.device)
  e[0] = 1.0
  return e


def balance_costs(w: dict, control_dt: float):
  """(rc(X, A) -> (B,), fc(X) -> (B,)) of the balance task, weights `w`."""
  q0 = standing_q()
  z0, stand = float(q0[2]), q0[7:]

  def rc(X, A):
    q, v = X[:, :19], X[:, 19:]
    qs = torch.as_tensor(stand, dtype=X.dtype, device=X.device)
    return (w["height"] * (q[:, 2] - z0) ** 2
            + w["orientation"] * torch.sum(quat_box_minus(q[:, 3:7], _ident(X)) ** 2, 1)
            + w["base_vel"] * torch.sum(v[:, :6] ** 2, 1)
            + w["joint_vel"] * torch.sum(v[:, 6:] ** 2, 1)
            + w["posture"] * torch.sum((q[:, 7:] - qs) ** 2, 1)
            + w["effort"] * torch.sum((A - qs) ** 2, 1)) * control_dt

  def fc(X):
    q, v = X[:, :19], X[:, 19:]
    return (200.0 * (q[:, 2] - z0) ** 2
            + 50.0 * torch.sum(quat_box_minus(q[:, 3:7], _ident(X)) ** 2, 1)
            + 5.0 * torch.sum(v[:, :6] ** 2, 1))

  return rc, fc


def trot_costs(v_target: float, control_dt: float, field_of):
  """(rc(X, A, heights), fc(X, heights)) of the trot on each row's terrain;
  `field_of(heights)` gives the rows' heightfield."""
  z0 = float(standing_q()[2])

  def rc(X, A, heights):
    q, v = X[:, :19], X[:, 19:]
    zs = surface_at(field_of(heights), q[:, :2])[0]
    return (9.0 * (v[:, 3] - v_target) ** 2 + 30.0 * (q[:, 2] - zs - z0) ** 2
            + 8.0 * torch.sum(quat_box_minus(q[:, 3:7], _ident(X)) ** 2, 1)
            + 0.3 * (v[:, 4] ** 2 + v[:, 5] ** 2)
            + 0.02 * torch.sum(v[:, 6:] ** 2, 1)) * control_dt

  def fc(X, heights):
    q = X[:, :19]
    zs = surface_at(field_of(heights), q[:, :2])[0]
    return (100.0 * (q[:, 2] - zs - z0) ** 2
            + 30.0 * torch.sum(quat_box_minus(q[:, 3:7], _ident(X)) ** 2, 1))

  return rc, fc

