"""The benchmark's inputs, made on the device from one seeded generator:
start states, PD targets, push directions and fractal terrains.

The terrain is the system's fractal value noise (per octave, lattice values
in [-1, 1) upsampled with smoothstep, geometric amplitude decay), copied so
that the inputs do not depend on the code under test.
"""

from __future__ import annotations

import torch

from portbench.reference.collide import Field, surface_at
from portbench.reference.model import standing_q


def stance(dtype, device) -> torch.Tensor:
  """(nq,) the nominal standing configuration."""
  return torch.as_tensor(standing_q(), dtype=dtype, device=device)


def standing_states(B: int, noise: float, gen, dtype, device):
  """(q (B, nq), u (B, nv)): the stance with N(0, noise) on every coordinate
  (the quaternion renormalised) and zero velocity."""
  q0 = stance(dtype, device)
  q = q0 + noise * torch.randn((B, q0.numel()), generator=gen, dtype=dtype, device=device)
  q[:, 3:7] = q[:, 3:7] / q[:, 3:7].norm(dim=1, keepdim=True)
  return q, torch.zeros((B, q0.numel() - 1), dtype=dtype, device=device)


def pd_targets(steps: int, B: int, sigma: float, gen, dtype, device):
  """(steps, B, nv) PD targets: the stance's joint angles plus N(0, sigma),
  fresh per step and world; zero on the floating base."""
  q0 = stance(dtype, device)
  nv = q0.numel() - 1
  pd = torch.zeros((steps, B, nv), dtype=dtype, device=device)
  pd[..., 6:] = q0[7:] + sigma * torch.randn((steps, B, nv - 6), generator=gen, dtype=dtype,
                                             device=device)
  return pd


def _grid(cells: int, n: int, dtype, device):
  f = torch.arange(n, dtype=dtype, device=device) * (float(cells) / float(n - 1))
  f[-1] = float(cells)
  return f


def _upsample(lat, nx: int, ny: int, cx: int, cy: int):
  fx, fy = _grid(cx, nx, lat.dtype, lat.device), _grid(cy, ny, lat.dtype, lat.device)
  ix = torch.floor(fx).long().clamp(0, cx - 1)
  iy = torch.floor(fy).long().clamp(0, cy - 1)
  ux, uy = fx - ix, fy - iy
  sx, sy = ux * ux * (3.0 - 2.0 * ux), uy * uy * (3.0 - 2.0 * uy)
  b = torch.arange(lat.shape[0], device=lat.device)[:, None, None]
  i, j = ix[None, :, None], iy[None, None, :]
  v00, v10, v01, v11 = lat[b, i, j], lat[b, i + 1, j], lat[b, i, j + 1], lat[b, i + 1, j + 1]
  a = v00 + sx[None, :, None] * (v10 - v00)
  c = v01 + sx[None, :, None] * (v11 - v01)
  return a + sy[None, None, :] * (c - a)


def terrains(n: int, t: dict, size, samples, gen, dtype, device):
  """(n, nx, ny) fractal heightfields of `size` m with `samples` points a
  side; `t` holds z_scale, frequency, octaves, lacunarity and gain."""
  nx, ny = samples
  h = torch.zeros((n, nx, ny), dtype=dtype, device=device)
  amp, freq = 0.5 * t["z_scale"], t["frequency"]
  for _ in range(t["octaves"]):
    cx, cy = max(1, int(round(freq * size[0]))), max(1, int(round(freq * size[1])))
    lat = 2.0 * torch.rand((n, cx + 1, cy + 1), generator=gen, dtype=dtype, device=device) - 1.0
    h = h + amp * _upsample(lat, nx, ny, cx, cy)
    amp *= t["gain"]
    freq *= t["lacunarity"]
  return h


def ground_height(heights, size, xy):
  """(B,) the terrain's height under the points xy (B, 2), per world."""
  field = Field(heights, torch.zeros(2, dtype=heights.dtype, device=heights.device), size)
  return surface_at(field, xy)[0]
