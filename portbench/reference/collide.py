"""Contacts of sphere and box geoms with the ground plane or a heightmap.

A frozen copy of the system's narrow phase for these pairs: a sphere gives
one slot, a box its 8 corners; on a heightmap a sphere also marches 4
samples along each horizontal direction out to its radius (risers and steep
triangles). Depth > 0 means penetration; a slot is active where it
penetrates (and, on a heightmap, lies over the field).
"""

from __future__ import annotations

import torch

from portbench.reference.model import GEOM_SPHERE

CORNERS = [(sx, sy, sz) for sx in (-1.0, 1.0) for sy in (-1.0, 1.0) for sz in (-1.0, 1.0)]


class Field:
  """A regular-grid heightfield of size (sx, sy) m centred at (cx, cy):
  heights (B, nx, ny), one field per world."""

  def __init__(self, heights, center, size):
    self.heights, self.center, self.size = heights, center, size


def surface_at(field: Field, xy):
  """Height, unit normal and in-bounds mask under the points xy (B, ..., 2),
  from the triangle of the cell that holds each point."""
  H = field.heights
  nx, ny = H.shape[-2:]
  dx, dy = field.size[0] / (nx - 1), field.size[1] / (ny - 1)
  fx = (xy[..., 0] - field.center[0] + 0.5 * field.size[0]) / dx
  fy = (xy[..., 1] - field.center[1] + 0.5 * field.size[1]) / dy
  inside = (fx >= 0.0) & (fx <= nx - 1.0) & (fy >= 0.0) & (fy <= ny - 1.0)
  i = torch.floor(fx).long().clamp(0, nx - 2)
  j = torch.floor(fy).long().clamp(0, ny - 2)
  u = (fx - i).clamp(0.0, 1.0)
  v = (fy - j).clamp(0.0, 1.0)
  b = torch.arange(H.shape[0], device=H.device).view((-1,) + (1,) * (i.ndim - 1))
  h00, h10, h01, h11 = H[b, i, j], H[b, i + 1, j], H[b, i, j + 1], H[b, i + 1, j + 1]
  lower = (u + v) <= 1.0
  z = torch.where(lower, h00 + u * (h10 - h00) + v * (h01 - h00),
                  h11 + (1.0 - u) * (h01 - h11) + (1.0 - v) * (h10 - h11))
  gx = torch.where(lower, h10 - h00, h11 - h01) / dx
  gy = torch.where(lower, h01 - h00, h11 - h10) / dy
  n = torch.stack([-gx, -gy, torch.ones_like(gx)], -1)
  return z, n / torch.sqrt(torch.sum(n * n, -1, keepdim=True) + 1e-18), inside


def _field_contact(field: Field, p, r):
  """Spheres of centres p (B, m, 3) and radii r (m,) (None: points) against
  the field: (pos, normal, depth, active)."""
  z, n, inside = surface_at(field, p[..., :2])
  rr = 0.0 if r is None else r
  depth = rr - n[..., 2] * (p[..., 2] - z)
  if r is None:
    return p, n, depth, (depth > 0) & inside
  best_d, best_n, best_in = depth, n, inside
  for ox, oy in ((1.0, 0.0), (-1.0, 0.0), (0.0, 1.0), (0.0, -1.0)):
    for f in (0.25, 0.5, 0.75, 1.0):
      qxy = torch.stack([p[..., 0] + ox * (f * r), p[..., 1] + oy * (f * r)], -1)
      zk, nk, ink = surface_at(field, qxy)
      dk = torch.sum(nk * (p - torch.cat([qxy, zk.unsqueeze(-1)], -1)), -1)
      dep_plane = torch.where(nk[..., 2] < 0.77, r - dk, -1.0)
      dep_wall = torch.where(zk > p[..., 2], r - f * r, -1.0)
      use_plane = dep_plane >= dep_wall
      dep = torch.maximum(dep_plane, dep_wall)
      wall = (-ox, -oy, 0.0)
      nc = torch.stack([torch.where(use_plane, nk[..., a], wall[a]) for a in range(3)], -1)
      better = dep > best_d
      best_d = torch.where(better, dep, best_d)
      best_n = torch.where(better.unsqueeze(-1), nc, best_n)
      best_in = torch.where(better, ink, best_in)
  return p - r.unsqueeze(-1) * best_n, best_n, best_d, (best_d > 0) & best_in


def collide(scene, kin, field: Field = None):
  """(pos (B, nc, 3), normal, depth (B, nc), active (B, nc)) of every slot,
  in the order of the scene's pairs (a box's corners sx, then sy, then sz)."""
  out = []
  for g in scene.pair_geoms:
    R, p0 = kin.R[:, g["body"]], kin.p[:, g["body"]]
    p = p0 + mv(R, g["offset_pos_t"])
    if g["gtype"] == GEOM_SPHERE:
      pts, r = p[:, None], g["params_t"][:1]
    else:
      Rg = R @ g["offset_rot_t"]
      pts = p[:, None] + (Rg[:, None] @ g["corners_t"][None, :, :, None]).squeeze(-1)
      r = None
    if field is None:
      h = scene.ground_height
      nrm = torch.zeros_like(pts)
      nrm[..., 2] = 1.0
      depth = (h - pts[..., 2]) if r is None else (h + r) - pts[..., 2]
      pos = pts if r is None else pts - r * nrm
      out.append((pos, nrm, depth, depth > 0))
    else:
      out.append(_field_contact(field, pts, r))
  return tuple(torch.cat(x, 1) for x in zip(*out))


def mv(M, v):
  return (M @ v.unsqueeze(-1)).squeeze(-1)
