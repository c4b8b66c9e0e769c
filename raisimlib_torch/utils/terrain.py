"""Procedural terrain: RaiSim's `TerrainProperties` and fractal heightfields.

Counterpart of raisimlib_tpu/utils/terrain.py. The noise model is the same
fractal value noise: per octave, i.i.d. lattice values in [-1, 1) upsampled to
the output grid with smoothstep (Hermite) interpolation, summed with
geometric amplitude decay. The lattice comes from an explicit
`torch.Generator` (the JAX package draws it from a `jax.random` key, so the
two give different terrains from the same seed); `_value_noise_from_lattice`
upsamples a given lattice, so that the same lattice gives the same field in
both packages.

Every function builds its field on `device` (None: the card).
"""

from __future__ import annotations

import dataclasses

import torch

from raisimlib_torch._device import resolve_device
from raisimlib_torch.ops.heightmap import HeightField


@dataclasses.dataclass(frozen=True)
class TerrainProperties:
  """Static terrain configuration (sizes in m, samples per axis)."""

  x_size: float = 8.0
  y_size: float = 8.0
  x_samples: int = 64
  y_samples: int = 64
  frequency: float = 0.5      # base lattice cells per metre
  z_scale: float = 0.3        # peak-to-peak height of the first octave
  fractal_octaves: int = 3
  fractal_lacunarity: float = 2.0
  fractal_gain: float = 0.5


def _grid(cells: int, n: int, dtype, device):
  """n points from 0 to `cells` inclusive, as the JAX package's linspace:
  start + k * delta, with the last point exactly `cells`."""
  delta = (torch.tensor(float(cells), dtype=dtype)
           / torch.tensor(float(n - 1), dtype=dtype)).to(device)
  f = torch.arange(n, dtype=dtype, device=device) * delta
  f[-1] = float(cells)
  return f


def _value_noise_from_lattice(lat, nx: int, ny: int, cells_x: int, cells_y: int):
  """One octave: the lattice `lat` (cells_x + 1, cells_y + 1), smoothstep-
  upsampled to (nx, ny)."""
  fx = _grid(cells_x, nx, lat.dtype, lat.device)
  fy = _grid(cells_y, ny, lat.dtype, lat.device)
  ix = torch.floor(fx).long().clamp(0, cells_x - 1)
  iy = torch.floor(fy).long().clamp(0, cells_y - 1)
  ux = fx - ix
  uy = fy - iy
  # Hermite smoothstep keeps the gradient continuous across lattice lines
  sx = ux * ux * (3.0 - 2.0 * ux)
  sy = uy * uy * (3.0 - 2.0 * uy)
  v00 = lat[ix[:, None], iy[None, :]]
  v10 = lat[ix[:, None] + 1, iy[None, :]]
  v01 = lat[ix[:, None], iy[None, :] + 1]
  v11 = lat[ix[:, None] + 1, iy[None, :] + 1]
  a = v00 + sx[:, None] * (v10 - v00)
  b = v01 + sx[:, None] * (v11 - v01)
  return a + sy[None, :] * (b - a)


def generate(props: TerrainProperties = TerrainProperties(), generator=None,
             center=(0.0, 0.0), dtype=torch.float32, device=None) -> HeightField:
  """Fractal-noise heightfield, its lattices drawn from `generator` (a
  torch.Generator; None: the global one)."""
  dev = resolve_device(device)
  gen_dev = generator.device if generator is not None else dev
  nx, ny = props.x_samples, props.y_samples
  h = torch.zeros((nx, ny), dtype=dtype, device=dev)
  amp = 0.5 * props.z_scale
  freq = props.frequency
  for _ in range(props.fractal_octaves):
    cx = max(1, int(round(freq * props.x_size)))
    cy = max(1, int(round(freq * props.y_size)))
    lat = 2.0 * torch.rand((cx + 1, cy + 1), generator=generator, dtype=dtype,
                           device=gen_dev) - 1.0
    h = h + amp * _value_noise_from_lattice(lat.to(dev), nx, ny, cx, cy)
    amp *= props.fractal_gain
    freq *= props.fractal_lacunarity
  return HeightField(heights=h, center=torch.as_tensor(center, dtype=dtype, device=dev),
                     size_x=float(props.x_size), size_y=float(props.y_size))


def flat(height=0.0, size=(8.0, 8.0), samples=(8, 8), center=(0.0, 0.0),
         dtype=torch.float32, device=None) -> HeightField:
  dev = resolve_device(device)
  return HeightField(heights=torch.full(tuple(samples), float(height), dtype=dtype, device=dev),
                     center=torch.as_tensor(center, dtype=dtype, device=dev),
                     size_x=float(size[0]), size_y=float(size[1]))


def slope(grade: float, size=(8.0, 8.0), samples=(32, 32), center=(0.0, 0.0),
          dtype=torch.float32, device=None) -> HeightField:
  """Plane tilted along +x: z = grade * x (world frame)."""
  dev = resolve_device(device)
  xs = torch.linspace(-0.5 * size[0], 0.5 * size[0], samples[0], dtype=dtype, device=dev)
  h = ((center[0] + xs)[:, None] * grade).expand(samples[0], samples[1]).contiguous()
  return HeightField(heights=h, center=torch.as_tensor(center, dtype=dtype, device=dev),
                     size_x=float(size[0]), size_y=float(size[1]))


def stairs(step_width: float, step_height: float, size=(8.0, 8.0),
           samples=(128, 16), center=(0.0, 0.0), dtype=torch.float32,
           device=None) -> HeightField:
  """Staircase rising along +x from the field's -x edge."""
  dev = resolve_device(device)
  xs = torch.linspace(0.0, size[0], samples[0], dtype=dtype, device=dev)
  levels = torch.floor(xs / step_width) * step_height
  h = levels[:, None].expand(samples[0], samples[1]).contiguous()
  return HeightField(heights=h, center=torch.as_tensor(center, dtype=dtype, device=dev),
                     size_x=float(size[0]), size_y=float(size[1]))
