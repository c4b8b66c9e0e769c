"""Heightmap terrain: a regular-grid heightfield and its narrow phase, batched
over worlds.

Counterpart of raisimlib_tpu/ops/heightmap.py. A query point (x, y) falls in a
grid cell split into two triangles (lower when u + v <= 1); the surface height
and normal there come from that triangle's plane, and the penetration is the
signed point-plane distance, masked to the field's extent.

Slot counts per geom follow the primitive-vs-plane ones: a sphere gives 1
contact slot, a capsule 2 (its end spheres), a box 8 (its corners), a
cylinder 6 (3 rim points per cap) and a cone 4 (the apex and 3 base-rim
points), both in the runtime downhill frame of collision.downhill_frame, and
a convex mesh 4 (of its hull vertices, the 4 deepest below the surface).
Spheres and capsule ends (r > 0) also march 4 samples along each of the 4
horizontal directions out to r, so that a stairs riser is met before the
centre crosses it (`_point_contact`); every other probe is a point.

`heights` is (nx, ny) for one field that every world shares, or (B, nx, ny)
for one field per world (batched terrain scenarios): the JAX package's
`vmap` over heights becomes a leading batch dimension and advanced indexing.
"""

from __future__ import annotations

import dataclasses

import torch

from raisimlib_torch.ops import collision as coll


@dataclasses.dataclass(frozen=True)
class HeightField:
  """Regular-grid heightfield centred at (cx, cy): z = h(x, y), triangle cells.

  heights[..., i, j] is the height at x-index i, y-index j; the grid spans
  [cx - size_x/2, cx + size_x/2] x [cy - size_y/2, cy + size_y/2]."""

  heights: torch.Tensor   # (nx, ny), or (B, nx, ny): one field per world
  center: torch.Tensor    # (2,)
  size_x: float = 1.0
  size_y: float = 1.0

  @property
  def shape(self) -> tuple:
    """(nx, ny)."""
    return tuple(self.heights.shape[-2:])

  def replace(self, **changes) -> "HeightField":
    return dataclasses.replace(self, **changes)


def _gather(H, i, j):
  """H[i, j] per world for index tensors i, j of shape (B, ...): H (nx, ny) is
  shared by every world, H (B, nx, ny) gives world b its own field."""
  if H.ndim == 2:
    return H[i, j]
  b = torch.arange(H.shape[0], device=H.device).view((-1,) + (1,) * (i.ndim - 1))
  return H[b, i, j]


def surface_at(field: HeightField, xy):
  """Surface height z (B, ...), unit normal n (B, ..., 3) and in-bounds mask
  (B, ...) at world points xy (B, ..., 2), from the triangle that contains
  each point (lower triangle (0,0)-(1,0)-(0,1) when u + v <= 1)."""
  H = field.heights
  nx, ny = H.shape[-2:]
  dx = field.size_x / (nx - 1)
  dy = field.size_y / (ny - 1)

  fx = (xy[..., 0] - field.center[0] + 0.5 * field.size_x) / dx
  fy = (xy[..., 1] - field.center[1] + 0.5 * field.size_y) / dy
  inside = (fx >= 0.0) & (fx <= nx - 1.0) & (fy >= 0.0) & (fy <= ny - 1.0)

  i = torch.floor(fx).long().clamp(0, nx - 2)
  j = torch.floor(fy).long().clamp(0, ny - 2)
  u = (fx - i).clamp(0.0, 1.0)
  v = (fy - j).clamp(0.0, 1.0)

  h00 = _gather(H, i, j)
  h10 = _gather(H, i + 1, j)
  h01 = _gather(H, i, j + 1)
  h11 = _gather(H, i + 1, j + 1)

  lower = (u + v) <= 1.0
  z_low = h00 + u * (h10 - h00) + v * (h01 - h00)
  z_up = h11 + (1.0 - u) * (h01 - h11) + (1.0 - v) * (h10 - h11)
  z = torch.where(lower, z_low, z_up)

  gx = torch.where(lower, h10 - h00, h11 - h01) / dx
  gy = torch.where(lower, h01 - h00, h11 - h10) / dy
  n = torch.stack([-gx, -gy, torch.ones_like(gx)], -1)
  n = n / torch.sqrt(torch.sum(n * n, -1, keepdim=True) + 1e-18)
  return z, n, inside


def _point_contact(field: HeightField, p, r):
  """Contact of spheres (centres p (B, ..., 3), radius r) with the field;
  r = 0.0 (a Python float) for points. A tensor r broadcasts against
  p[..., 0]. Returns (pos, normal, depth, valid).

  The depth is the signed distance to the local triangle plane, which passes
  through the surface point below p: depth = r - n_z (p_z - z). For r > 0, 4
  samples along each of the 4 horizontal directions out to r add two kinds
  of gated candidates, and the deepest wins (first match on ties):

    * plane candidates where a sample's triangle is steep (n_z < 0.77):
      depth = r - (distance from p to that plane);
    * wall candidates where a sample's surface is above the centre: normal
      -direction (horizontal), depth = r - f r at marching fraction f.

  Flat or gentle terrain triggers neither gate. A point (r = 0) keeps the
  single sample below it."""
  z, n, inside = surface_at(field, p[..., :2])
  dtype, dev = p.dtype, p.device
  r_col = r.unsqueeze(-1) if torch.is_tensor(r) else r
  dist = n[..., 2] * (p[..., 2] - z)
  depth = r - dist
  pos = p - r_col * n
  if isinstance(r, float) and r == 0.0:
    return pos, n, depth, (depth > 0) & inside

  r = torch.as_tensor(r, dtype=dtype, device=dev)
  r_col = r.unsqueeze(-1)
  best_d, best_n, best_in = depth, n, inside
  for ox, oy in ((1.0, 0.0), (-1.0, 0.0), (0.0, 1.0), (0.0, -1.0)):
    ndir = (-ox, -oy, 0.0)                        # wall normal: towards p
    for f in (0.25, 0.5, 0.75, 1.0):
      # the offsets and the wall normal as Python scalars: no host-made
      # tensor, whose copy to the card would synchronise
      qxy = torch.stack([p[..., 0] + ox * (f * r), p[..., 1] + oy * (f * r)], -1)
      z_k, n_k, in_k = surface_at(field, qxy)
      s_pt = torch.cat([qxy, z_k.unsqueeze(-1)], -1)
      d_k = torch.sum(n_k * (p - s_pt), -1)
      dep_plane = torch.where(n_k[..., 2] < 0.77, r - d_k, -1.0)
      dep_wall = torch.where(z_k > p[..., 2], r - f * r, -1.0)
      use_plane = dep_plane >= dep_wall
      dep_k = torch.maximum(dep_plane, dep_wall)
      n_c = torch.stack([torch.where(use_plane, n_k[..., a], ndir[a]) for a in range(3)], -1)
      better = dep_k > best_d
      best_d = torch.where(better, dep_k, best_d)
      best_n = torch.where(better.unsqueeze(-1), n_c, best_n)
      best_in = torch.where(better, in_k, best_in)
  pos = p - r_col * best_n
  return pos, best_n, best_d, (best_d > 0) & best_in


def _sphere_points(geoms, idxs, kin):
  gi = torch.as_tensor(idxs, device=kin.p.device)
  _, c = coll._group_poses(geoms, idxs, kin)
  return c.unsqueeze(2), geoms.params[gi, 0].unsqueeze(1)           # (B,m,1,3), (m,1)


def _capsule_points(geoms, idxs, kin):
  gi = torch.as_tensor(idxs, device=kin.p.device)
  r, hl = geoms.params[gi, 0], geoms.params[gi, 1]
  R, p = coll._group_poses(geoms, idxs, kin)
  ends = [p + R[..., 2] * (s * hl.unsqueeze(-1)) for s in (-1.0, 1.0)]
  return torch.stack(ends, 2), r.unsqueeze(1)                        # (B,m,2,3), (m,1)


def _box_points(geoms, idxs, kin):
  gi = torch.as_tensor(idxs, device=kin.p.device)
  he = geoms.params[gi, :3]
  R, p = coll._group_poses(geoms, idxs, kin)
  S = torch.as_tensor(coll._CORNER_SIGNS, dtype=p.dtype, device=p.device)
  local = he[:, None, :] * S[None]                                   # (m, 8, 3)
  corners = p[:, :, None, :] + (R[:, :, None] @ local[..., None]).squeeze(-1)
  return corners, 0.0                                                # (B,m,8,3)


def _cylinder_points(geoms, idxs, kin):
  gi = torch.as_tensor(idxs, device=kin.p.device)
  R, p = coll._group_poses(geoms, idxs, kin)
  return coll.cylinder_points(R, p, geoms.params[gi, 0], geoms.params[gi, 1]), 0.0


def _cone_points(geoms, idxs, kin):
  gi = torch.as_tensor(idxs, device=kin.p.device)
  R, p = coll._group_poses(geoms, idxs, kin)
  return coll.cone_points(R, p, geoms.params[gi, 0], geoms.params[gi, 1]), 0.0


_POINTS = {coll.GEOM_SPHERE: _sphere_points, coll.GEOM_CAPSULE: _capsule_points,
           coll.GEOM_BOX: _box_points, coll.GEOM_CYLINDER: _cylinder_points,
           coll.GEOM_CONE: _cone_points}


def _mesh_contacts(geoms, idxs, kin, field):
  """Every hull vertex probed as a point, the padding masked to -inf depth,
  and the 4 deepest kept per mesh (equal depths in vertex order): (pos,
  normal, depth, valid), each (B, m, 4, ...)."""
  V, mask = coll.mesh_world_verts(geoms, idxs, kin)
  pos, n, depth, valid = _point_contact(field, V, 0.0)
  depth = torch.where(mask, depth, -torch.inf)
  top = coll.deepest4(depth)

  def pick(x):
    return torch.gather(x, 2, top.view(top.shape + (1,) * (x.ndim - 3)).expand(
        top.shape + x.shape[3:]))

  return pick(pos), pick(n), pick(depth), pick(valid & mask)


def collide_group(geoms, idxs, kin, field: HeightField):
  """Every geom of `idxs` (one geom type, each attached to a body) against the
  field: (pos (B, n, 3), normal (B, n, 3), depth (B, n), valid (B, n)) with
  the geoms' slots in order, n = len(idxs) x the type's slot count."""
  t = geoms.gtype[idxs[0]]
  if t == coll.GEOM_MESH:
    pos, n, depth, valid = _mesh_contacts(geoms, idxs, kin, field)
  else:
    pts, r = _POINTS[t](geoms, idxs, kin)
    pos, n, depth, valid = _point_contact(field, pts, r)
  B = pos.shape[0]
  return (pos.reshape(B, -1, 3), n.reshape(B, -1, 3), depth.reshape(B, -1),
          valid.reshape(B, -1))


def collide_heightmap(geoms, gi: int, kin, field: HeightField):
  """Narrow phase of geom `gi` against the field: one (pos (B, 3), normal,
  depth (B,), valid) per slot (sphere 1, capsule 2, box 8, cylinder 6, cone
  4, mesh 4)."""
  pos, n, depth, valid = collide_group(geoms, [gi], kin, field)
  return list(zip(pos.unbind(1), n.unbind(1), depth.unbind(1), valid.unbind(1)))
