"""Collision detection over a static pair list, batched over worlds.

Counterpart of raisimlib_tpu/ops/collision.py, restricted to sphere, box,
capsule, cylinder, cone and convex mesh against the ground plane and against
a heightmap (ops/heightmap.py), and a sphere against a sphere, a box or a
capsule (the runtime-frame pairs). Every other pair type (box-box,
capsule-capsule, a sphere against a cylinder or a mesh, and the
support-function pairs, which include any two of cylinder, cone and mesh) is
rejected when the scene is built (candidate_pairs) and again by `collide`,
with an error that names it.

A convex mesh is a table of at most MAX_MESH_VERTS hull vertices
(`hull_support_sample`), padded to that width; its narrow phase probes the
vertices and keeps the 4 deepest.

The plane and heightmap pairs run grouped by type; the sphere pairs run one
pair at a time, each gated by the broad phase's AABB overlap
(`broadphase_mask`), as in the JAX package.

Contact convention: the normal points from geom B towards geom A; relative
velocity is v(A) - v(B) at the contact point; depth > 0 means penetration.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from raisimlib_torch._device import resolve_device

GEOM_SPHERE = 0
GEOM_BOX = 1
GEOM_CAPSULE = 2
GEOM_PLANE = 3
GEOM_HEIGHTMAP = 4
GEOM_CYLINDER = 5
GEOM_MESH = 6
GEOM_CONE = 7

# convex meshes: hull vertex tables, padded to a fixed width
MAX_MESH_VERTS = 32

GEOM_NAMES = {GEOM_SPHERE: "sphere", GEOM_BOX: "box", GEOM_CAPSULE: "capsule",
              GEOM_PLANE: "plane", GEOM_HEIGHTMAP: "heightmap",
              GEOM_CYLINDER: "cylinder", GEOM_MESH: "mesh", GEOM_CONE: "cone"}

# slots contributed per ported pair type (keyed by sorted gtype pair)
_PAIR_SLOTS = {
    (GEOM_SPHERE, GEOM_SPHERE): 1,
    (GEOM_SPHERE, GEOM_BOX): 1,
    (GEOM_SPHERE, GEOM_CAPSULE): 1,
    (GEOM_SPHERE, GEOM_PLANE): 1,
    (GEOM_BOX, GEOM_PLANE): 8,
    (GEOM_CAPSULE, GEOM_PLANE): 2,
    (GEOM_SPHERE, GEOM_HEIGHTMAP): 1,
    (GEOM_BOX, GEOM_HEIGHTMAP): 8,
    (GEOM_CAPSULE, GEOM_HEIGHTMAP): 2,
    (GEOM_PLANE, GEOM_CYLINDER): 6,       # 3 rim points per cap
    (GEOM_HEIGHTMAP, GEOM_CYLINDER): 6,
    (GEOM_PLANE, GEOM_MESH): 4,           # the 4 deepest hull vertices
    (GEOM_HEIGHTMAP, GEOM_MESH): 4,
    (GEOM_PLANE, GEOM_CONE): 4,           # apex + 3 base rim points
    (GEOM_HEIGHTMAP, GEOM_CONE): 4,
}


def _unported(ta: int, tb: int) -> NotImplementedError:
  return NotImplementedError(
      f"geom pair ({GEOM_NAMES.get(ta, ta)}, {GEOM_NAMES.get(tb, tb)}) has no "
      f"narrow phase in raisimlib_torch yet (ported: sphere, box, capsule, "
      f"cylinder, cone and mesh vs plane and heightmap, sphere vs "
      f"sphere/box/capsule); see ROADMAP.md item 13 (the rest of collision)")


@dataclasses.dataclass(frozen=True)
class GeomSpec:
  """One collision geom as World accumulates it (World's _GeomSpec)."""

  body: int           # merged-model body index; -1 = static world
  gtype: int
  params: np.ndarray  # (4,) sphere r; box hx,hy,hz; capsule/cylinder r,hl; cone r,h; plane h
  offset_pos: np.ndarray
  offset_rot: np.ndarray
  material: int
  obj: int = -1       # owning object id; same-obj pairs skipped unless self_collision
  mesh: np.ndarray = None   # (n, 3) convex-hull vertices of a mesh geom


@dataclasses.dataclass(frozen=True)
class GeomTable:
  """Numeric geom parameters + static type/body metadata."""

  gtype: tuple
  body: tuple
  material: tuple
  params: torch.Tensor      # (ng, 4)
  offset_pos: torch.Tensor  # (ng, 3)
  offset_rot: torch.Tensor  # (ng, 3, 3)
  # hull vertex tables (body frame, geom offset applied), zero for non-mesh
  # geoms; None for a table without meshes
  mesh_verts: torch.Tensor = None   # (ng, MAX_MESH_VERTS, 3)
  mesh_vcount: tuple = ()           # vertices per geom, 0 for non-mesh


def hull_support_sample(verts, k: int = MAX_MESH_VERTS) -> np.ndarray:
  """Reduce a vertex cloud to <= k points: the extreme vertex along each of
  k quasi-uniform directions (a Fibonacci sphere), in vertex order. A cloud
  of at most k vertices is returned as it is; a larger one warns. Clouds
  that collapse to fewer than 4 support vertices are topped up with
  farthest-point vertices, so that a mesh hull always has 4."""
  import warnings

  verts = np.asarray(verts, np.float64).reshape(-1, 3)
  if len(verts) <= k:
    return verts
  warnings.warn(
      f"hull_support_sample: reducing a {len(verts)}-vertex hull to <= {k} "
      f"support vertices (exact for vertex contacts; conservative on "
      f"faces/edges)", stacklevel=2)
  idx = np.arange(k)
  phi = np.pi * (3.0 - np.sqrt(5.0)) * idx
  z = 1.0 - 2.0 * (idx + 0.5) / k
  r = np.sqrt(np.maximum(1.0 - z * z, 0.0))
  dirs = np.stack([r * np.cos(phi), r * np.sin(phi), z], axis=1)
  picked = np.unique(np.argmax(verts @ dirs.T, axis=0))
  while len(picked) < min(4, len(verts)):
    d2 = np.min(np.sum((verts[:, None, :] - verts[picked][None, :, :]) ** 2, axis=2),
                axis=1)
    picked = np.append(picked, int(np.argmax(d2)))
  return verts[np.sort(picked)]


def build_geom_table(specs: Sequence[GeomSpec], dtype=torch.float32,
                     device=None) -> GeomTable:
  """The numeric geom tables on `device` (None: the card, see
  _device.resolve_device). A mesh geom's hull (hull_support_sample) goes
  into mesh_verts with its geom offset baked in, padded with its vertex 0."""
  device = resolve_device(device)
  ng = len(specs)
  params = np.zeros((ng, 4))
  opos = np.zeros((ng, 3))
  orot = np.zeros((ng, 3, 3))
  mverts = np.zeros((ng, MAX_MESH_VERTS, 3))
  mcount = []
  for i, g in enumerate(specs):
    params[i] = g.params
    opos[i] = g.offset_pos
    orot[i] = g.offset_rot
    if g.mesh is None:
      mcount.append(0)
      continue
    mv = hull_support_sample(g.mesh)
    n = len(mv)
    if n < 4:
      raise ValueError(f"a mesh hull needs >= 4 vertices, geom {i} has {n}")
    mverts[i, :n] = np.asarray(g.offset_pos)[None] + mv @ np.asarray(g.offset_rot).T
    mverts[i, n:] = mverts[i, 0]             # padding repeats a real vertex (masked)
    mcount.append(n)

  def t(x):
    return torch.as_tensor(x, dtype=dtype, device=device)

  return GeomTable(gtype=tuple(int(g.gtype) for g in specs),
                   body=tuple(int(g.body) for g in specs),
                   material=tuple(int(g.material) for g in specs),
                   params=t(params), offset_pos=t(opos), offset_rot=t(orot),
                   mesh_verts=t(mverts), mesh_vcount=tuple(mcount))


def candidate_pairs(specs: Sequence[GeomSpec], model, self_collision: bool = False) -> tuple:
  """Static candidate pair list (ia, ib), same filter and canonical order as
  the JAX package: no same-body, parent-child, same-object (unless
  self_collision) or static-static pairs; the plane or heightmap comes
  second, otherwise the lower geom type comes first (so a sphere comes
  before a box or a capsule, as the pair kernels assume)."""
  pairs = []
  for i in range(len(specs)):
    for j in range(i + 1, len(specs)):
      bi, bj = specs[i].body, specs[j].body
      if bi == bj:
        continue
      if specs[i].obj >= 0 and specs[i].obj == specs[j].obj and not self_collision:
        continue
      if bi >= 0 and bj >= 0 and (model.parent[bi] == bj or model.parent[bj] == bi):
        continue
      if bi < 0 and bj < 0:
        continue
      ti, tj = int(specs[i].gtype), int(specs[j].gtype)
      if tuple(sorted((ti, tj))) not in _PAIR_SLOTS:
        raise _unported(ti, tj)
      if ti in (GEOM_PLANE, GEOM_HEIGHTMAP):
        pairs.append((j, i))
      elif tj in (GEOM_PLANE, GEOM_HEIGHTMAP) or ti <= tj:
        pairs.append((i, j))
      else:
        pairs.append((j, i))
  return tuple(pairs)


def num_contact_slots(geoms: GeomTable, pairs: tuple) -> int:
  return sum(_PAIR_SLOTS[tuple(sorted((geoms.gtype[a], geoms.gtype[b])))]
             for a, b in pairs)


@dataclasses.dataclass
class ContactSet:
  """Padded, statically-shaped contact manifold for a batch of worlds."""

  pos: torch.Tensor     # (B, nc, 3) contact point, world
  normal: torch.Tensor  # (B, nc, 3) unit normal, world (B -> A)
  depth: torch.Tensor   # (B, nc)
  active: torch.Tensor  # (B, nc) 1.0 / 0.0
  body_a: tuple
  body_b: tuple
  mat_a: tuple
  mat_b: tuple


def _geom_pose(geoms: GeomTable, gi: int, kin):
  """World pose (R (B,3,3), p (B,3)) of geom gi."""
  b = geoms.body[gi]
  op, oR = geoms.offset_pos[gi], geoms.offset_rot[gi]
  if b < 0:
    B = kin.p.shape[0]
    return oR.expand(B, 3, 3), op.expand(B, 3)
  Rb = kin.R[:, b]
  return Rb @ oR, kin.p[:, b] + (Rb @ op.unsqueeze(-1)).squeeze(-1)


def _up(like):
  n = torch.zeros_like(like)
  n[..., 2] = 1.0
  return n


# per-pair kernels: a list of (pos (B,3), normal, depth (B,), valid) per slot

def _sphere_plane(geoms, ia, ib, kin):
  r, h = geoms.params[ia, 0], geoms.params[ib, 0]
  _, c = _geom_pose(geoms, ia, kin)
  n = _up(c)
  depth = (h + r) - c[:, 2]
  return [(c - r * n, n, depth, depth > 0)]


def _box_plane(geoms, ia, ib, kin):
  he, h = geoms.params[ia, :3], geoms.params[ib, 0]
  Ra, pa = _geom_pose(geoms, ia, kin)
  n = _up(pa)
  out = []
  for sx in (-1.0, 1.0):
    for sy in (-1.0, 1.0):
      for sz in (-1.0, 1.0):
        s = torch.tensor([sx, sy, sz], dtype=pa.dtype, device=pa.device)
        corner = pa + (Ra @ (he * s).unsqueeze(-1)).squeeze(-1)
        depth = h - corner[:, 2]
        out.append((corner, n, depth, depth > 0))
  return out


def _capsule_plane(geoms, ia, ib, kin):
  r, hl, h = geoms.params[ia, 0], geoms.params[ia, 1], geoms.params[ib, 0]
  Ra, pa = _geom_pose(geoms, ia, kin)
  axis = Ra[:, :, 2]
  n = _up(pa)
  out = []
  for s in (-1.0, 1.0):
    end = pa + axis * (s * hl)
    depth = (h + r) - end[:, 2]
    out.append((end - r * n, n, depth, depth > 0))
  return out


def _sphere_contact(ca, cb, ra, rb):
  """Sphere A (centre ca, radius ra) vs sphere B: the one slot."""
  d = ca - cb
  dist = torch.sqrt(torch.sum(d * d, -1) + 1e-18)
  n = d / dist[:, None]
  depth = (ra + rb) - dist
  pos = cb + n * (rb - 0.5 * depth)[:, None]
  return [(pos, n, depth, depth > 0)]


def _sphere_sphere(geoms, ia, ib, kin):
  _, ca = _geom_pose(geoms, ia, kin)
  _, cb = _geom_pose(geoms, ib, kin)
  return _sphere_contact(ca, cb, geoms.params[ia, 0], geoms.params[ib, 0])


def _sphere_capsule(geoms, ia, ib, kin):
  """Sphere (A) vs capsule (B): the sphere centre clamped onto the capsule's
  segment, then sphere against sphere."""
  rb, hlb = geoms.params[ib, 0], geoms.params[ib, 1]
  _, ca = _geom_pose(geoms, ia, kin)
  Rb, pb = _geom_pose(geoms, ib, kin)
  axis = Rb[:, :, 2]
  t = torch.clamp(torch.sum((ca - pb) * axis, -1), -hlb, hlb)
  return _sphere_contact(ca, pb + axis * t[:, None], geoms.params[ia, 0], rb)


def _sphere_box(geoms, ia, ib, kin):
  """Sphere (A) vs box (B): the closest point of the box when the centre is
  outside; a centre inside resolves along the face of least penetration
  (first match on ties, as an argmin), with a sign that is never 0 (a zero
  normal would make the contact block singular)."""
  r = geoms.params[ia, 0]
  he = geoms.params[ib, :3]
  _, c = _geom_pose(geoms, ia, kin)
  Rb, pb = _geom_pose(geoms, ib, kin)
  cl = (Rb.transpose(-1, -2) @ (c - pb).unsqueeze(-1)).squeeze(-1)   # box frame
  clamped = torch.minimum(torch.maximum(cl, -he), he)
  delta = cl - clamped
  dist = torch.sqrt(torch.sum(delta * delta, -1) + 1e-18)
  outside = dist > 1e-9
  n_out = delta / dist[:, None]
  face_pen = he - cl.abs()                                  # >= 0 when inside
  is0 = (face_pen[:, 0] <= face_pen[:, 1]) & (face_pen[:, 0] <= face_pen[:, 2])
  is1 = ~is0 & (face_pen[:, 1] <= face_pen[:, 2])
  k = torch.where(is0, 0, torch.where(is1, 1, 2))
  pen_k = face_pen.gather(1, k[:, None])[:, 0]
  sgn = torch.where(cl >= 0.0, 1.0, -1.0).to(cl.dtype)
  n_in = sgn * torch.nn.functional.one_hot(k, 3).to(cl.dtype)
  n_local = torch.where(outside[:, None], n_out, n_in)
  depth = torch.where(outside, r - dist, r + pen_k)
  surf = torch.where(outside[:, None], clamped, cl + n_in * pen_k[:, None])
  n = (Rb @ n_local.unsqueeze(-1)).squeeze(-1)
  pos = pb + (Rb @ surf.unsqueeze(-1)).squeeze(-1)
  return [(pos, n, depth, depth > 0)]


# cylinders, cones and meshes: probe points in a runtime frame. The plane
# kernels here and the heightmap's (ops/heightmap.py) share them.

RIM_PHI = (0.0, 2.0943951, -2.0943951)       # downhill, then +-120 degrees


def downhill_frame(R):
  """(a, u, w), each (..., 3), of geom rotations R (..., 3, 3): the axis a
  (R's z column), the rim direction u deepest below a plane normal to +z
  (z projected off the axis, negated, normalised), and w = a x u. When the
  axis is vertical (projection below 1e-6) u is R's x column, which gives a
  stable 3-point face."""
  a = R[..., :, 2]
  ax, ay, az = a.unbind(-1)
  radial = torch.stack([-(az * ax), -(az * ay), 1.0 - az * az], -1)   # z - (z . a) a
  rn = torch.sqrt(torch.sum(radial * radial, -1, keepdim=True))
  degenerate = rn < 1e-6
  u = torch.where(degenerate, R[..., :, 0], -radial / torch.where(degenerate, 1.0, rn))
  u = u / torch.sqrt(torch.sum(u * u, -1, keepdim=True) + 1e-18)
  return a, u, torch.linalg.cross(a, u, dim=-1)


def _rim(c, r, u, w, phi):
  return c + r * (float(np.cos(phi)) * u + float(np.sin(phi)) * w)


def cylinder_points(R, p, r, hl):
  """The 6 rim probes (..., 6, 3) of cylinders at (R, p) with radius r and
  half-length hl (shape p[..., 0]): per cap (bottom, top) the downhill rim
  point and the points +-120 degrees round from it."""
  a, u, w = downhill_frame(R)
  r, hl = r.unsqueeze(-1), hl.unsqueeze(-1)
  return torch.stack([_rim(p + a * (s * hl), r, u, w, phi)
                      for s in (-1.0, 1.0) for phi in RIM_PHI], -2)


def cone_points(R, p, r, h):
  """The 4 probes (..., 4, 3) of cones at (R, p) (the COM: apex at +0.75 h
  on the axis, base ring of radius r at -0.25 h): the apex, then the
  downhill base-rim point and the points +-120 degrees round from it."""
  a, u, w = downhill_frame(R)
  r, h = r.unsqueeze(-1), h.unsqueeze(-1)
  base_c = p - a * (0.25 * h)
  return torch.stack([p + a * (0.75 * h)] + [_rim(base_c, r, u, w, phi) for phi in RIM_PHI],
                     -2)


def mesh_world_verts(geoms: GeomTable, idxs, kin):
  """(B, m, MAX_MESH_VERTS, 3) hull vertices of the body-attached mesh geoms
  `idxs` in the world frame (the geom offset is in mesh_verts already), and
  their mask (m, MAX_MESH_VERTS): False on the padding rows."""
  dev = kin.p.device
  gi = torch.as_tensor(idxs, device=dev)
  bi = torch.as_tensor([geoms.body[g] for g in idxs], device=dev)
  V = geoms.mesh_verts[gi]                                        # (m, 32, 3)
  Rb, pb = kin.R[:, bi], kin.p[:, bi]
  verts = pb[:, :, None, :] + V @ Rb.transpose(-1, -2)
  count = torch.as_tensor([geoms.mesh_vcount[g] for g in idxs], device=dev)
  return verts, torch.arange(MAX_MESH_VERTS, device=dev) < count[:, None]


def deepest4(depths):
  """Indices (..., 4) of the 4 largest depths along the last axis, equal
  depths in index order (the order of the JAX package's lax.top_k)."""
  return torch.sort(depths, dim=-1, descending=True, stable=True).indices[..., :4]


def _plane_probes(pts, h):
  """Point probes (B, k, 3) against the plane z = h: one slot each."""
  n = _up(pts)
  depth = h - pts[..., 2]
  return list(zip(pts.unbind(1), n.unbind(1), depth.unbind(1), (depth > 0).unbind(1)))


def _cylinder_plane(geoms, ia, ib, kin):
  """Cylinder (A) vs plane (B): the 6 rim probes of cylinder_points."""
  R, p = _geom_pose(geoms, ia, kin)
  return _plane_probes(cylinder_points(R, p, geoms.params[ia, 0], geoms.params[ia, 1]),
                       geoms.params[ib, 0])


def _cone_plane(geoms, ia, ib, kin):
  """Cone (A) vs plane (B): the apex and 3 base-rim probes of cone_points."""
  R, p = _geom_pose(geoms, ia, kin)
  return _plane_probes(cone_points(R, p, geoms.params[ia, 0], geoms.params[ia, 1]),
                       geoms.params[ib, 0])


def _mesh_plane(geoms, ia, ib, kin):
  """Convex mesh (A) vs plane (B): the 4 deepest hull vertices."""
  V, mask = mesh_world_verts(geoms, [ia], kin)
  V, mask = V[:, 0], mask[0]
  depths = torch.where(mask, geoms.params[ib, 0] - V[..., 2], -torch.inf)
  top = deepest4(depths)
  pts = torch.gather(V, 1, top[..., None].expand(-1, -1, 3))
  d = torch.gather(depths, 1, top)
  n = _up(pts)
  return list(zip(pts.unbind(1), n.unbind(1), d.unbind(1), (d > 0).unbind(1)))


# broad phase: a masked AABB overlap test per bounded pair

_AABB_BIG = 3e38


def geom_aabb(geoms: GeomTable, gi: int, kin):
  """World-frame AABB (lo, hi), each (B, 3), of geom gi: a sphere, box or
  capsule; planes and heightmaps are unbounded."""
  gt = geoms.gtype[gi]
  R, p = _geom_pose(geoms, gi, kin)
  if gt in (GEOM_PLANE, GEOM_HEIGHTMAP):
    return torch.full_like(p, -_AABB_BIG), torch.full_like(p, _AABB_BIG)
  if gt == GEOM_SPHERE:
    e = geoms.params[gi, 0].expand(p.shape)
  elif gt == GEOM_BOX:
    e = (R.abs() @ geoms.params[gi, :3].unsqueeze(-1)).squeeze(-1)
  elif gt == GEOM_CAPSULE:
    e = R[:, :, 2].abs() * geoms.params[gi, 1] + geoms.params[gi, 0]
  else:
    raise _unported(gt, gt)
  return p - e, p + e


def broadphase_mask(geoms: GeomTable, pairs: tuple, kin):
  """Per pair: True (no operation) against an unbounded geom (plane,
  heightmap), else a (B,) bool tensor, whether the two AABBs overlap. The
  pair list stays static; the mask gates the narrow phase's `active`."""
  boxes = {}
  masks = []
  unbounded = (GEOM_PLANE, GEOM_HEIGHTMAP)
  for ia, ib in pairs:
    if geoms.gtype[ia] in unbounded or geoms.gtype[ib] in unbounded:
      masks.append(True)
      continue
    for g in (ia, ib):
      if g not in boxes:
        boxes[g] = geom_aabb(geoms, g, kin)
    (lo_a, hi_a), (lo_b, hi_b) = boxes[ia], boxes[ib]
    masks.append(((lo_a <= hi_b) & (lo_b <= hi_a)).all(-1))
  return masks


# grouped kernels: every pair of one type in a few batched ops

def _group_poses(geoms: GeomTable, idxs, kin):
  """World poses (B,m,3,3), (B,m,3) of body-attached geoms `idxs`."""
  bodies = [geoms.body[g] for g in idxs]
  assert min(bodies) >= 0
  gi = torch.as_tensor(idxs, device=kin.p.device)
  bi = torch.as_tensor(bodies, device=kin.p.device)
  Rb, pb = kin.R[:, bi], kin.p[:, bi]
  R = Rb @ geoms.offset_rot[gi]
  p = pb + (Rb @ geoms.offset_pos[gi].unsqueeze(-1)).squeeze(-1)
  return R, p


def _plane_heights(geoms, members, device):
  return geoms.params[torch.as_tensor([ib for _, ib in members], device=device), 0]


def _b_sphere_plane(geoms, members, kin):
  idx_a = [ia for ia, _ in members]
  gi = torch.as_tensor(idx_a, device=kin.p.device)
  r = geoms.params[gi, 0]
  h = _plane_heights(geoms, members, kin.p.device)
  _, c = _group_poses(geoms, idx_a, kin)
  n = _up(c)
  depth = (h + r) - c[..., 2]
  return c - r[:, None] * n, n, depth, depth > 0


def _b_capsule_plane(geoms, members, kin):
  idx_a = [ia for ia, _ in members]
  gi = torch.as_tensor(idx_a, device=kin.p.device)
  r, hl = geoms.params[gi, 0], geoms.params[gi, 1]
  h = _plane_heights(geoms, members, kin.p.device)
  R, p = _group_poses(geoms, idx_a, kin)
  signs = torch.tensor([-1.0, 1.0], dtype=p.dtype, device=p.device)
  ends = p[:, :, None, :] + R[:, :, None, :, 2] * (signs[:, None] * hl[:, None, None])
  n = _up(ends)
  depth = (h[:, None] + r[:, None]) - ends[..., 2]          # (B, m, 2)
  B, m = p.shape[:2]
  pos = ends - r[:, None, None] * n
  return (pos.reshape(B, 2 * m, 3), n.reshape(B, 2 * m, 3),
          depth.reshape(B, 2 * m), depth.reshape(B, 2 * m) > 0)


_CORNER_SIGNS = np.array([[sx, sy, sz] for sx in (-1.0, 1.0)
                          for sy in (-1.0, 1.0) for sz in (-1.0, 1.0)])


def _b_box_plane(geoms, members, kin):
  idx_a = [ia for ia, _ in members]
  gi = torch.as_tensor(idx_a, device=kin.p.device)
  he = geoms.params[gi, :3]                                  # (m, 3)
  h = _plane_heights(geoms, members, kin.p.device)
  R, p = _group_poses(geoms, idx_a, kin)
  S = torch.as_tensor(_CORNER_SIGNS, dtype=p.dtype, device=p.device)
  local = he[:, None, :] * S[None]                            # (m, 8, 3)
  corners = p[:, :, None, :] + (R[:, :, None] @ local[..., None]).squeeze(-1)
  n = _up(corners)
  depth = h[:, None] - corners[..., 2]                        # (B, m, 8)
  B, m = p.shape[:2]
  return (corners.reshape(B, 8 * m, 3), n.reshape(B, 8 * m, 3),
          depth.reshape(B, 8 * m), depth.reshape(B, 8 * m) > 0)


_BATCHED = {
    (GEOM_SPHERE, GEOM_PLANE): (_b_sphere_plane, 1),
    (GEOM_CAPSULE, GEOM_PLANE): (_b_capsule_plane, 2),
    (GEOM_BOX, GEOM_PLANE): (_b_box_plane, 8),
}
# the single-pair forms: for the sphere, capsule and box plane pairs slot for
# slot the same as the grouped ones; the sphere pairs and the cylinder, cone
# and mesh plane pairs run only in this form
SINGLE = {
    (GEOM_SPHERE, GEOM_PLANE): _sphere_plane,
    (GEOM_BOX, GEOM_PLANE): _box_plane,
    (GEOM_CAPSULE, GEOM_PLANE): _capsule_plane,
    (GEOM_SPHERE, GEOM_SPHERE): _sphere_sphere,
    (GEOM_SPHERE, GEOM_BOX): _sphere_box,
    (GEOM_SPHERE, GEOM_CAPSULE): _sphere_capsule,
    (GEOM_CYLINDER, GEOM_PLANE): _cylinder_plane,
    (GEOM_CONE, GEOM_PLANE): _cone_plane,
    (GEOM_MESH, GEOM_PLANE): _mesh_plane,
}


def collide(geoms: GeomTable, pairs: tuple, kin, heightmap=None) -> ContactSet:
  """Run all pair kernels and assemble the padded ContactSet; `heightmap` is
  the scene's HeightField (ops/heightmap.py) when it has heightmap pairs.

  Plane and heightmap pairs are computed group by type, the sphere pairs one
  by one with the broad phase's mask ANDed into their `active`; all slots
  are restored to the canonical per-pair slot order by one static
  permutation, so the solver's row order (the Gauss-Seidel sweep order) is
  the JAX package's."""
  from raisimlib_torch.ops import heightmap as hm

  B = kin.p.shape[0]
  dtype, dev = kin.p.dtype, kin.p.device
  slot_of_pair = []
  body_a, body_b, mat_a, mat_b = [], [], [], []
  total = 0
  for ia, ib in pairs:
    key = (geoms.gtype[ia], geoms.gtype[ib])
    on_field = key[1] == GEOM_HEIGHTMAP and tuple(sorted(key)) in _PAIR_SLOTS
    if key not in _BATCHED and key not in SINGLE and not on_field:
      raise _unported(*key)
    if on_field and heightmap is None:
      raise ValueError("the scene has heightmap pairs but no heightmap was given")
    ns = _PAIR_SLOTS[tuple(sorted(key))]
    slot_of_pair.append(total)
    total += ns
    body_a += [geoms.body[ia]] * ns
    body_b += [geoms.body[ib]] * ns
    mat_a += [geoms.material[ia]] * ns
    mat_b += [geoms.material[ib]] * ns

  # a plane or heightmap pair has a body-attached geom on its A side
  # (candidate_pairs skips static-static pairs), so it runs grouped
  bp = broadphase_mask(geoms, pairs, kin)
  groups = {}
  singles = []
  for pi, (ia, ib) in enumerate(pairs):
    key = (geoms.gtype[ia], geoms.gtype[ib])
    if key in _BATCHED or key[1] == GEOM_HEIGHTMAP:
      groups.setdefault(key, []).append((pi, ia, ib))
    else:
      singles.append((pi, ia, ib))

  pos_c, nrm_c, dep_c, act_c = [], [], [], []
  computed = []
  for pi, ia, ib in singles:
    for si, (pos, nrm, dep, val) in enumerate(
        SINGLE[(geoms.gtype[ia], geoms.gtype[ib])](geoms, ia, ib, kin)):
      pos_c.append(pos[:, None])
      nrm_c.append(nrm[:, None])
      dep_c.append(dep[:, None])
      act_c.append((val & bp[pi])[:, None].to(dtype))
      computed.append(slot_of_pair[pi] + si)
  for key, entries in groups.items():
    if key[1] == GEOM_HEIGHTMAP:
      ns = _PAIR_SLOTS[tuple(sorted(key))]
      pos, nrm, dep, val = hm.collide_group(geoms, [ia for _, ia, _ in entries], kin,
                                            heightmap)
    else:
      fn, ns = _BATCHED[key]
      pos, nrm, dep, val = fn(geoms, [(ia, ib) for _, ia, ib in entries], kin)
    pos_c.append(pos)
    nrm_c.append(nrm)
    dep_c.append(dep)
    act_c.append(val.to(dtype))
    for pi, _, _ in entries:
      computed += list(range(slot_of_pair[pi], slot_of_pair[pi] + ns))

  if not pos_c:            # no candidate pairs: one inert slot keeps shapes static
    normal = torch.zeros((B, 1, 3), dtype=dtype, device=dev)
    normal[..., 2] = 1.0
    zeros = torch.zeros((B, 1), dtype=dtype, device=dev)
    return ContactSet(pos=torch.zeros((B, 1, 3), dtype=dtype, device=dev),
                      normal=normal, depth=zeros, active=zeros.clone(),
                      body_a=(-1,), body_b=(-1,), mat_a=(0,), mat_b=(0,))

  pos, nrm = torch.cat(pos_c, 1), torch.cat(nrm_c, 1)
  dep, act = torch.cat(dep_c, 1), torch.cat(act_c, 1)
  perm = np.zeros(total, dtype=np.int64)
  perm[np.array(computed)] = np.arange(total)
  if not np.array_equal(perm, np.arange(total)):
    idx = torch.as_tensor(perm, device=dev)
    pos, nrm, dep, act = pos[:, idx], nrm[:, idx], dep[:, idx], act[:, idx]
  return ContactSet(pos=pos, normal=nrm, depth=dep, active=act,
                    body_a=tuple(body_a), body_b=tuple(body_b),
                    mat_a=tuple(mat_a), mat_b=tuple(mat_b))
