"""Collision detection over a static pair list, batched over worlds.

Counterpart of raisimlib_tpu/ops/collision.py, with its whole pair table:
every pair of sphere, box, capsule, cylinder, cone and convex mesh, with
each other, with the ground plane and with a heightmap (ops/heightmap.py).
Box-box is the 15-axis separating-axis test with a fixed 9-slot manifold;
capsule-capsule, sphere-cylinder and sphere-mesh are analytic; every other
pair of two bounded geoms goes through the generic support-function kernel
(`_b_support_pair`, a 4-slot perturbed manifold). None of these is in the
fused step's class (ops/gpu_step.py): a scene holding one steps on the K2
path, as in the JAX package.

A convex mesh is a table of at most MAX_MESH_VERTS hull vertices
(`hull_support_sample`), padded to that width.

The plane and heightmap pairs, and the pairs of two bounded geoms other than
the sphere pairs, run grouped by type: all pairs of one type at once, each
slot with the JAX kernel's arithmetic. The sphere pairs run one pair at a
time. The pairs of two bounded geoms are gated by the broad phase's AABB
overlap (`broadphase_mask`), as in the JAX package.

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

# slots contributed per pair type (keyed by sorted gtype pair): the JAX
# package's table
_PAIR_SLOTS = {
    (GEOM_SPHERE, GEOM_SPHERE): 1,
    (GEOM_SPHERE, GEOM_BOX): 1,
    (GEOM_SPHERE, GEOM_CAPSULE): 1,
    (GEOM_SPHERE, GEOM_PLANE): 1,
    (GEOM_BOX, GEOM_BOX): 9,              # 4 + 4 face slots, 1 edge slot
    (GEOM_BOX, GEOM_PLANE): 8,
    (GEOM_CAPSULE, GEOM_PLANE): 2,
    (GEOM_CAPSULE, GEOM_CAPSULE): 1,
    (GEOM_SPHERE, GEOM_HEIGHTMAP): 1,
    (GEOM_CAPSULE, GEOM_HEIGHTMAP): 2,
    (GEOM_BOX, GEOM_HEIGHTMAP): 8,
    (GEOM_SPHERE, GEOM_CYLINDER): 1,
    (GEOM_PLANE, GEOM_CYLINDER): 6,       # 3 rim points per cap
    (GEOM_HEIGHTMAP, GEOM_CYLINDER): 6,
    (GEOM_SPHERE, GEOM_MESH): 1,
    (GEOM_PLANE, GEOM_MESH): 4,           # the 4 deepest hull vertices
    (GEOM_HEIGHTMAP, GEOM_MESH): 4,
    (GEOM_PLANE, GEOM_CONE): 4,           # apex + 3 base rim points
    (GEOM_HEIGHTMAP, GEOM_CONE): 4,
    # every other convex pair: the support-function kernel's 4 slots
    (GEOM_BOX, GEOM_CAPSULE): 4,
    (GEOM_BOX, GEOM_CYLINDER): 4,
    (GEOM_CAPSULE, GEOM_CYLINDER): 4,
    (GEOM_CYLINDER, GEOM_CYLINDER): 4,
    (GEOM_BOX, GEOM_MESH): 4,
    (GEOM_CAPSULE, GEOM_MESH): 4,
    (GEOM_CYLINDER, GEOM_MESH): 4,
    (GEOM_MESH, GEOM_MESH): 4,
    (GEOM_SPHERE, GEOM_CONE): 4,
    (GEOM_BOX, GEOM_CONE): 4,
    (GEOM_CAPSULE, GEOM_CONE): 4,
    (GEOM_CYLINDER, GEOM_CONE): 4,
    (GEOM_MESH, GEOM_CONE): 4,
    (GEOM_CONE, GEOM_CONE): 4,
}


def _no_narrow_phase(ta: int, tb: int) -> NotImplementedError:
  return NotImplementedError(
      f"geom pair ({GEOM_NAMES.get(ta, ta)}, {GEOM_NAMES.get(tb, tb)}) has no "
      f"narrow phase: no pair kernel exists for it (the JAX package's pair "
      f"table has none either, and drops such a pair with a warning)")


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
        raise _no_narrow_phase(ti, tj)
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


def _touch(ca, cb, ra, rb):
  """Sphere A (centre ca (..., 3), radius ra) against sphere B: (pos,
  normal, depth, valid) of the one slot."""
  d = ca - cb
  dist = torch.sqrt(torch.sum(d * d, -1) + 1e-18)
  n = d / dist[..., None]
  depth = (ra + rb) - dist
  pos = cb + n * (rb - 0.5 * depth)[..., None]
  return pos, n, depth, depth > 0


def _sphere_contact(ca, cb, ra, rb):
  return [_touch(ca, cb, ra, rb)]


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
  """(B, m, MAX_MESH_VERTS, 3) hull vertices of the mesh geoms `idxs` in the
  world frame (the geom offset is in mesh_verts already; a static mesh's
  vertices are its table), and their mask (m, MAX_MESH_VERTS): False on the
  padding rows."""
  dev = kin.p.device
  bodies = [geoms.body[g] for g in idxs]
  gi = torch.as_tensor(idxs, device=dev)
  bi = torch.as_tensor([max(b, 0) for b in bodies], device=dev)
  V = geoms.mesh_verts[gi]                                        # (m, 32, 3)
  Rb, pb = kin.R[:, bi], kin.p[:, bi]
  verts = pb[:, :, None, :] + V @ Rb.transpose(-1, -2)
  if min(bodies) < 0:
    static = torch.as_tensor([b < 0 for b in bodies], device=dev)
    verts = torch.where(static[:, None, None], V, verts)
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
_UNBOUNDED = (GEOM_PLANE, GEOM_HEIGHTMAP)


def _aabb(geoms: GeomTable, idxs, kin):
  """World-frame AABBs (lo, hi), each (B, m, 3), of the geoms `idxs`, all of
  one type; a plane's or a heightmap's is unbounded."""
  gt = geoms.gtype[idxs[0]]
  R, p = _group_poses(geoms, idxs, kin)
  if gt in _UNBOUNDED:
    return torch.full_like(p, -_AABB_BIG), torch.full_like(p, _AABB_BIG)
  prm = geoms.params[torch.as_tensor(idxs, device=p.device)]
  r = prm[:, 0, None]
  if gt == GEOM_SPHERE:
    e = r.expand(p.shape)
  elif gt == GEOM_BOX:
    e = (R.abs() @ prm[:, :3, None]).squeeze(-1)
  elif gt in (GEOM_CAPSULE, GEOM_CYLINDER):
    e = R[..., 2].abs() * prm[:, 1, None] + r
  elif gt == GEOM_CONE:
    e = R[..., 2].abs() * (0.75 * prm[:, 1, None]) + r    # apex and base ring
  else:                                                   # a mesh: its vertices
    V, mask = mesh_world_verts(geoms, idxs, kin)
    mask = mask[..., None]
    return (torch.where(mask, V, _AABB_BIG).amin(-2),
            torch.where(mask, V, -_AABB_BIG).amax(-2))
  return p - e, p + e


def geom_aabb(geoms: GeomTable, gi: int, kin):
  """World-frame AABB (lo, hi), each (B, 3), of geom gi; planes and
  heightmaps are unbounded."""
  lo, hi = _aabb(geoms, [gi], kin)
  return lo[:, 0], hi[:, 0]


def _overlap(a, b, margin: float):
  (lo_a, hi_a), (lo_b, hi_b) = a, b
  return ((lo_a <= hi_b + margin) & (lo_b <= hi_a + margin)).all(-1)


def broadphase_mask(geoms: GeomTable, pairs: tuple, kin, margin: float = 0.0):
  """Per pair: True (no operation) against an unbounded geom (plane,
  heightmap), else a (B,) bool tensor, whether the two AABBs, grown by
  `margin`, overlap. The pair list stays static; the mask gates the narrow
  phase's `active`."""
  boxes = {}
  masks = []
  for ia, ib in pairs:
    if geoms.gtype[ia] in _UNBOUNDED or geoms.gtype[ib] in _UNBOUNDED:
      masks.append(True)
      continue
    for g in (ia, ib):
      if g not in boxes:
        boxes[g] = geom_aabb(geoms, g, kin)
    masks.append(_overlap(boxes[ia], boxes[ib], margin))
  return masks


# grouped kernels: every pair of one type in a few batched ops

def _group_poses(geoms: GeomTable, idxs, kin):
  """World poses (B,m,3,3), (B,m,3) of the geoms `idxs`; a static geom
  (body -1) sits at its offset."""
  dev = kin.p.device
  bodies = [geoms.body[g] for g in idxs]
  gi = torch.as_tensor(idxs, device=dev)
  bi = torch.as_tensor([max(b, 0) for b in bodies], device=dev)
  oR, op = geoms.offset_rot[gi], geoms.offset_pos[gi]
  Rb, pb = kin.R[:, bi], kin.p[:, bi]
  R = Rb @ oR
  p = pb + (Rb @ op.unsqueeze(-1)).squeeze(-1)
  if min(bodies) < 0:
    static = torch.as_tensor([b < 0 for b in bodies], device=dev)
    R = torch.where(static[:, None, None], oR, R)
    p = torch.where(static[:, None], op, p)
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


# the pairs of two bounded geoms, all pairs of a type at once: each returns
# (pos (B,m,k,3), normal (B,m,k,3), depth (B,m,k), valid (B,m,k)) for the m
# pairs' k slots, each slot with the arithmetic of the JAX package's kernel
# (its literal guards included: they decide degenerate directions)


def _dot(a, b):
  return torch.sum(a * b, -1)


def _mv(M, v):
  return (M @ v.unsqueeze(-1)).squeeze(-1)


def _mtv(M, v):
  return (M.transpose(-1, -2) @ v.unsqueeze(-1)).squeeze(-1)


def _unit(x):
  return x / torch.sqrt(torch.sum(x * x, -1, keepdim=True) + 1e-18)


def _pm1(cond, like):
  """1 where cond, else -1, in like's dtype."""
  return torch.where(cond, 1.0, -1.0).to(like.dtype)


def _onehot(idx, n, like):
  return torch.nn.functional.one_hot(idx, n).to(like.dtype)


def _side_params(geoms, idxs, dev):
  return geoms.params[torch.as_tensor(idxs, device=dev)]


def _members(geoms, members, kin):
  """The A and B geoms of the pairs: their indices, poses and params."""
  ia = [a for a, _ in members]
  ib = [b for _, b in members]
  dev = kin.p.device
  return (ia, _group_poses(geoms, ia, kin), _side_params(geoms, ia, dev),
          ib, _group_poses(geoms, ib, kin), _side_params(geoms, ib, dev))


def _slot1(pos, n, depth, valid):
  return pos[:, :, None], n[:, :, None], depth[:, :, None], valid[:, :, None]


def _closest_segment_segment(p1, d1, hl1, p2, d2, hl2):
  """Closest points between the segments p1 +- hl1 d1 and p2 +- hl2 d2 (unit
  directions), by the clamped solve."""
  r = p1 - p2
  b = _dot(d1, d2)
  c = _dot(d1, r)
  f = _dot(d2, r)
  denom = 1.0 - b * b
  s = torch.where(denom.abs() > 1e-9, (b * f - c) / (denom + 1e-18), torch.zeros_like(b))
  s = torch.minimum(torch.maximum(s, -hl1), hl1)
  t = torch.minimum(torch.maximum(b * s + f, -hl2), hl2)
  s = torch.minimum(torch.maximum(b * t - c, -hl1), hl1)
  return p1 + d1 * s[..., None], p2 + d2 * t[..., None]


def _b_capsule_capsule(geoms, members, kin):
  """Capsule (A) vs capsule (B): the closest points of the two segments,
  then sphere against sphere; 1 slot."""
  _, (Ra, pa), prm_a, _, (Rb, pb), prm_b = _members(geoms, members, kin)
  qa, qb = _closest_segment_segment(pa, Ra[..., 2], prm_a[:, 1], pb, Rb[..., 2], prm_b[:, 1])
  return _slot1(*_touch(qa, qb, prm_a[:, 0], prm_b[:, 0]))


def _b_sphere_cylinder(geoms, members, kin):
  """Sphere (A) vs flat-capped cylinder (B), 1 slot: the exterior closest
  point (rho_dir min(rho, r), clip(z, -hl, hl)) in the cylinder's frame; a
  centre inside resolves along the smaller of the side and cap
  penetrations (a sign never 0)."""
  _, (_, ca), prm_a, _, (Rb, pb), prm_b = _members(geoms, members, kin)
  ra, r, hl = prm_a[:, 0], prm_b[:, 0], prm_b[:, 1]
  d = _mtv(Rb, ca - pb)
  z = d[..., 2]
  ez = _up(d)
  rho_v = torch.cat([d[..., :2], torch.zeros_like(d[..., 2:])], -1)
  rho = torch.sqrt(torch.sum(rho_v * rho_v, -1) + 1e-18)
  rho_dir = rho_v / rho[..., None]
  inside = (rho < r) & (z.abs() < hl)
  cl_out = (rho_dir * torch.minimum(rho, r)[..., None]
            + ez * torch.minimum(torch.maximum(z, -hl), hl)[..., None])
  delta = d - cl_out
  dist = torch.sqrt(torch.sum(delta * delta, -1) + 1e-18)
  n_out = delta / dist[..., None]
  pen_side = r - rho
  pen_cap = hl - z.abs()
  side_wins = (pen_side <= pen_cap)[..., None]
  sz = _pm1(z >= 0.0, z)[..., None]
  n_in = torch.where(side_wins, rho_dir, ez * sz)
  cl_in = torch.where(side_wins, rho_dir * r[:, None] + ez * z[..., None],
                      rho_v + ez * sz * hl[:, None])
  n_local = torch.where(inside[..., None], n_in, n_out)
  depth = torch.where(inside, ra + torch.minimum(pen_side, pen_cap), ra - dist)
  surf = torch.where(inside[..., None], cl_in, cl_out)
  return _slot1(_mv(Rb, surf) + pb, _mv(Rb, n_local), depth, depth > 0)


def _b_sphere_mesh(geoms, members, kin):
  """Sphere (A) vs convex mesh (B), 1 slot: the hull vertex nearest the
  centre (the first of equals) stands in for the support point."""
  ia, (_, ca), prm_a, ib, _, _ = _members(geoms, members, kin)
  V, mask = mesh_world_verts(geoms, ib, kin)
  dv = V - ca[:, :, None]
  d2 = torch.where(mask, torch.sum(dv * dv, -1), torch.inf)
  i = d2.argmin(-1)
  q = torch.gather(V, 2, i[..., None, None].expand(-1, -1, 1, 3))[:, :, 0]
  delta = ca - q
  dist = torch.sqrt(torch.sum(delta * delta, -1) + 1e-18)
  depth = prm_a[:, 0] - dist
  return _slot1(q, delta / dist[..., None], depth, depth > 0)


def _face_manifold(e_ref, e_inc, R_ri, t_ri, R_ref, p_ref, depth_ref, flip: bool):
  """Box-box's 4 reference-face slots: the incident box's face vertices
  against the reference box's slab (R_ri, t_ri: incident -> reference
  frame; flip: the reference box is B)."""
  oh_i = _onehot(depth_ref.argmin(-1), 3, depth_ref)         # reference axis
  s = _pm1(_dot(oh_i, t_ri) >= 0, t_ri)                      # its face toward the other
  oh_j = _onehot(_mtv(R_ri.abs(), oh_i).argmax(-1), 3, oh_i)  # incident face axis
  sgn_j = _dot(_mtv(R_ri, oh_i), oh_j)
  sb = -s * torch.sign(sgn_j + 1e-30)
  ebj = _dot(e_inc, oh_j)
  vb_c = t_ri + (sb * ebj)[..., None] * _mv(R_ri, oh_j)      # incident face centre
  oh_1, oh_2 = torch.roll(oh_j, 1, -1), torch.roll(oh_j, 2, -1)
  w1 = _dot(e_inc, oh_1)[..., None] * _mv(R_ri, oh_1)
  w2 = _dot(e_inc, oh_2)[..., None] * _mv(R_ri, oh_2)
  ea_i = _dot(e_ref, oh_i)
  n_w = _mv(R_ref, s[..., None] * oh_i)
  n_out = n_w if flip else -n_w                              # B -> A
  out = []
  for s1 in (-1.0, 1.0):
    for s2 in (-1.0, 1.0):
      v = vb_c + s1 * w1 + s2 * w2
      d_k = ea_i - s * _dot(v, oh_i)
      v_cl = torch.minimum(torch.maximum(v, -e_ref), e_ref)
      v_cl = v_cl * (1.0 - oh_i) + oh_i * s[..., None] * (ea_i - 0.5 * d_k)[..., None]
      out.append((p_ref + _mv(R_ref, v_cl), n_out, d_k, d_k > 0))
  return out


def _b_box_box(geoms, members, kin):
  """Box (A) vs box (B): the separating-axis test over 15 axes and a fixed
  9-slot manifold, 4 slots for A's face as the reference (B's incident face
  vertices), 4 for B's, 1 for the edge-edge case; one group is active, by
  the winning axis family (faces preferred by a 5% bias). B's reference
  slots differ from the JAX package's, which are wrong (see below)."""
  _, (Ra, pa), prm_a, _, (Rb, pb), prm_b = _members(geoms, members, kin)
  ea, eb = prm_a[:, :3].expand(pa.shape), prm_b[:, :3].expand(pb.shape)   # (B, m, 3)
  Rab = Ra.transpose(-1, -2) @ Rb                            # B's axes in A's frame
  tab = _mtv(Ra, pb - pa)
  Cabs = Rab.abs() + 1e-7
  depthA = (ea + _mv(Cabs, eb)) - tab.abs()
  tb = _mtv(Rab, tab)
  depthB = (eb + _mtv(Cabs, ea)) - tb.abs()
  # the 9 edge axes cross(a_i, b_j), i-major
  eye = torch.eye(3, dtype=pa.dtype, device=pa.device)
  cols = Rab.transpose(-1, -2)                               # row j: B's axis j
  cols = cols[:, :, None].expand(-1, -1, 3, -1, -1)
  ax = torch.linalg.cross(eye[:, None, :].expand(cols.shape), cols, dim=-1)
  ax = ax.reshape(ax.shape[:2] + (9, 3))
  n2 = torch.sum(ax * ax, -1)
  axu = ax * torch.rsqrt(torch.clamp(n2, min=1e-12))[..., None]
  ra = torch.sum(ea[:, :, None] * axu.abs(), -1)
  rb = torch.sum(eb[:, :, None] * (axu @ Rab).abs(), -1)
  d = (ra + rb) - _dot(axu, tab[:, :, None]).abs()
  depth_e = torch.where(n2 > 1e-8, d, torch.full_like(d, 3e38))
  bestA, bestB, bestE = depthA.amin(-1), depthB.amin(-1), depth_e.amin(-1)
  overlap = (bestA > 0) & (bestB > 0) & (bestE > 0)
  face_wins = torch.minimum(bestA, bestB) <= bestE * 1.05 + 1e-9
  a_wins = face_wins & (bestA <= bestB)
  b_wins = face_wins & ~(bestA <= bestB)
  e_wins = ~face_wins
  slots = [(pos, n, dk, v & a_wins & overlap)
           for pos, n, dk, v in _face_manifold(ea, eb, Rab, tab, Ra, pa, depthA, False)]
  # B's face as the reference: the incident box A's centre in B's frame is
  # -tb. The JAX package passes tb there (raisimlib_tpu/ops/collision.py
  # _box_box, `mfB`), which turns the normal to A -> B and puts the points
  # on B's far face, so that a box B resting on a smaller box A (B's face
  # the least penetrated by 1e-7 of the axes' sums) sinks through it; with
  # -tb these slots are the A-reference slots of the pair (B, A), the normal
  # turned back to B -> A
  slots += [(pos, n, dk, v & b_wins & overlap)
            for pos, n, dk, v in _face_manifold(eb, ea, Rab.transpose(-1, -2), -tb, Rb, pb,
                                                depthB, True)]
  # the edge-edge case: the closest points of the two winning edges
  oh_e = _onehot(depth_e.argmin(-1), 9, depth_e)
  n_e = (oh_e.unsqueeze(-2) @ axu).squeeze(-2)               # A-frame unit axis
  n_e = n_e * _pm1(_dot(n_e, tab) >= 0, n_e)[..., None]       # oriented A -> B
  oh3 = oh_e.reshape(oh_e.shape[:2] + (3, 3))
  oh_ei, oh_ej = oh3.sum(-1), oh3.sum(-2)                    # A's, B's edge direction
  pa_e = torch.sign(n_e) * ea * (1.0 - oh_ei)
  nb = -_mtv(Rab, n_e)                                       # in B's frame, toward A
  pb_e = tab + _mv(Rab, torch.sign(nb) * eb * (1.0 - oh_ej))
  qa, qb = _closest_segment_segment(pa_e, oh_ei, _dot(ea, oh_ei), pb_e, _mv(Rab, oh_ej),
                                    _dot(eb, oh_ej))
  d_e = _dot(oh_e, depth_e)
  slots.append((pa + _mv(Ra, 0.5 * (qa + qb)), -_mv(Ra, n_e), d_e,
                e_wins & overlap & (d_e > 0)))
  return tuple(torch.stack(x, 2) for x in zip(*slots))


def _fib_sphere(k: int) -> np.ndarray:
  """k quasi-uniform unit directions."""
  idx = np.arange(k)
  phi = np.pi * (3.0 - np.sqrt(5.0)) * idx
  z = 1.0 - 2.0 * (idx + 0.5) / k
  r = np.sqrt(np.maximum(1.0 - z * z, 0.0))
  return np.stack([r * np.cos(phi), r * np.sin(phi), z], axis=1)


# the support-function kernel's coarse directions, and its 3 x 3 tangent grid
_SAT_DIRS = _fib_sphere(128)
_GRID_OFFS = np.array([(i, j) for i in (-1.0, 0.0, 1.0) for j in (-1.0, 0.0, 1.0)])


@dataclasses.dataclass
class _Side:
  """The geoms on one side of a group of support pairs (one geom type)."""

  gtype: int
  R: torch.Tensor                 # (B, m, 3, 3)
  p: torch.Tensor                 # (B, m, 3)
  prm: torch.Tensor               # (m, 4)
  V: torch.Tensor = None          # (B, m, MAX_MESH_VERTS, 3), meshes only
  mask: torch.Tensor = None       # (m, MAX_MESH_VERTS)


def _side(geoms, idxs, kin) -> _Side:
  gt = geoms.gtype[idxs[0]]
  R, p = _group_poses(geoms, idxs, kin)
  side = _Side(gt, R, p, _side_params(geoms, idxs, p.device))
  if gt == GEOM_MESH:
    side.V, side.mask = mesh_world_verts(geoms, idxs, kin)
  return side


def support_points(side: _Side, D):
  """Farthest points (B, m, k, 3) of the side's geoms along the world unit
  directions D (B, m, k, 3) (the JAX package's support_points, all pairs of
  a group at once)."""
  if side.gtype == GEOM_MESH:
    dots = torch.where(side.mask[:, None], D @ side.V.transpose(-1, -2), -torch.inf)
    i = dots.argmax(-1)
    return torch.gather(side.V, 2, i[..., None].expand(i.shape + (3,)))
  R = side.R[:, :, None]
  dl = (D.unsqueeze(-2) @ R).squeeze(-2)                    # in the geom's frame
  gt, prm = side.gtype, side.prm[:, None]                    # (m, 1, 4)
  r, hl = prm[..., 0:1], prm[..., 1:2]
  if gt == GEOM_SPHERE:
    sl = r * dl
  elif gt == GEOM_BOX:
    sl = prm[..., :3] * _pm1(dl >= 0.0, dl)
  elif gt == GEOM_CAPSULE:
    sl = r * dl + _up(dl) * (hl * torch.sign(dl[..., 2:3] + 1e-30))
  elif gt in (GEOM_CYLINDER, GEOM_CONE):
    rho = torch.sqrt(dl[..., 0:1] * dl[..., 0:1] + dl[..., 1:2] * dl[..., 1:2] + 1e-18)
    scale = torch.where(rho > 1e-6, r / rho, torch.zeros_like(rho))
    if gt == GEOM_CYLINDER:
      sl = torch.cat([dl[..., :2] * scale, hl * torch.sign(dl[..., 2:3] + 1e-30)], -1)
    else:                          # hl holds the cone's height h
      apex = _up(dl) * (0.75 * hl)
      base = torch.cat([dl[..., :2] * scale, (-0.25 * hl).expand(dl[..., 2:3].shape)], -1)
      apex_wins = _dot(dl, apex) >= _dot(dl, base)
      sl = torch.where(apex_wins[..., None], apex, base)
  else:
    raise NotImplementedError(f"support map of geom type {gt}")
  return side.p[:, :, None] + (R @ sl.unsqueeze(-1)).squeeze(-1)


def _first_top3(x):
  """Indices (..., 3) of the 3 largest entries along the last axis, equal
  entries in index order (as lax.top_k): first-match argmax, masked."""
  picks = []
  for _ in range(3):
    i = x.argmax(-1)
    picks.append(i)
    x = x.scatter(-1, i[..., None], -torch.inf)
  return torch.stack(picks, -1)


def _feature_normals(side: _Side, d):
  """Candidate exact directions (B, m, 3) from the side's flat or axial
  features, oriented along d: a box's face axis, a cylinder's or cone's
  cap and radial directions, a capsule's radial one, and a mesh's
  supporting face (the plane of its 3 vertices most extreme along d).
  Spheres give none."""
  gt = side.gtype
  if gt == GEOM_MESH:
    dots = torch.where(side.mask, _mv(side.V, d), -torch.inf)
    top = _first_top3(dots)
    v1, v2, v3 = (torch.gather(side.V, 2, top[..., k, None, None].expand(-1, -1, 1, 3))[:, :, 0]
                  for k in range(3))
    nf = _unit(torch.linalg.cross(v2 - v1, v3 - v1, dim=-1))
    return [nf * torch.sign(_dot(nf, d) + 1e-30)[..., None]]
  R = side.R
  dl = _mtv(R, d)
  if gt == GEOM_BOX:
    oh = _onehot(dl.abs().argmax(-1), 3, dl)
    return [_mv(R, oh * torch.sign(dl + 1e-30))]
  a = R[..., 2]
  rad = _unit(d - _dot(d, a)[..., None] * a)
  if gt in (GEOM_CYLINDER, GEOM_CONE):
    return [a * torch.sign(dl[..., 2] + 1e-30)[..., None], rad]
  if gt == GEOM_CAPSULE:
    return [rad]
  return []


def _tangents(d):
  """(t1, t2) orthogonal to the unit directions d (..., 3), by the
  least-aligned-axis pick."""
  ax = d.abs()
  eye = torch.eye(3, dtype=d.dtype, device=d.device)
  pick_x = ((ax[..., 0] <= ax[..., 1]) & (ax[..., 0] <= ax[..., 2]))[..., None]
  pick_y = ~pick_x & (ax[..., 1] <= ax[..., 2])[..., None]
  a = torch.where(pick_x, eye[0], torch.where(pick_y, eye[1], eye[2]))
  t1 = _unit(torch.linalg.cross(d, a, dim=-1))
  return t1, torch.linalg.cross(d, t1, dim=-1)


def _pick(D, h):
  """The direction of D (B, m, k, 3) at the first least h (B, m, k)."""
  i = h.argmin(-1)
  return torch.gather(D, 2, i[..., None, None].expand(-1, -1, 1, 3))[:, :, 0]


def _b_support_pair(geoms, members, kin):
  """Every other convex pair (box, capsule, cylinder, cone and mesh among
  themselves, and a sphere with a cone): the sampled separating-axis search
  over support functions and its 4-slot perturbed manifold.

  The penetration depth of convex A, B is the least Minkowski support h(d)
  = d.sA(d) - d.sB(-d) over unit d. The search takes the least over 128
  Fibonacci directions and the centre line, refines it in 6 halving 3 x 3
  tangent grids, then tries the feature normals (`_feature_normals`). The
  slots are the witness pairs on 4 axes tilted 0.12 rad about the result,
  each placed at the mid-penetration point of the side that sits deeper
  inside the other along the witnesses' tangent."""
  ia = [a for a, _ in members]
  ib = [b for _, b in members]
  A, Bs = _side(geoms, ia, kin), _side(geoms, ib, kin)
  dtype, dev = A.p.dtype, A.p.device

  def h_of(D):
    return _dot(D, support_points(A, D) - support_points(Bs, -D))

  dc = _unit(Bs.p - A.p)
  sat = torch.as_tensor(_SAT_DIRS, dtype=dtype, device=dev)
  D0 = torch.cat([sat.expand(dc.shape[:2] + sat.shape), dc[:, :, None], -dc[:, :, None]], 2)
  d = _pick(D0, h_of(D0))
  offs = torch.as_tensor(_GRID_OFFS, dtype=dtype, device=dev)
  span = 0.4
  for _ in range(6):
    t1, t2 = _tangents(d)
    Dr = d[:, :, None] + span * (offs[:, :1] * t1[:, :, None] + offs[:, 1:] * t2[:, :, None])
    Dr = _unit(Dr)
    d = _pick(Dr, h_of(Dr))
    span *= 0.5
  cands = _feature_normals(A, d) + [-c for c in _feature_normals(Bs, -d)]
  Dc = torch.stack([d] + cands, 2)
  d = _pick(Dc, h_of(Dc))

  t1, t2 = _tangents(d)
  Dm = torch.stack([_unit(d + 0.12 * tv) for tv in (t1, -t1, t2, -t2)], 2)
  pA, pB = support_points(A, Dm), support_points(Bs, -Dm)
  dk = d[:, :, None]
  depth = _dot(dk, pA - pB)                                  # (B, m, 4)
  cA = pA - (0.5 * depth)[..., None] * dk
  cB = pB + (0.5 * depth)[..., None] * dk
  t = cB - cA
  t = t - dk * _dot(dk, t)[..., None]
  tn = torch.sqrt(torch.sum(t * t, -1) + 1e-18)
  th = t / tn[..., None]
  hA = _dot(th, support_points(A, th))
  hB = _dot(-th, support_points(Bs, -th))
  margin_B = hA - _dot(th, cB)
  margin_A = hB + _dot(th, cA)
  pick = torch.where((margin_B >= margin_A)[..., None], cB, cA)
  pos = torch.where((tn < 1e-6)[..., None], 0.5 * (cA + cB), pick)
  return pos, (-d)[:, :, None].expand(pos.shape), depth, depth > 0


# the pairs of two bounded geoms that run grouped: key -> (kernel, slots)
_GROUPED = {
    (GEOM_BOX, GEOM_BOX): (_b_box_box, 9),
    (GEOM_CAPSULE, GEOM_CAPSULE): (_b_capsule_capsule, 1),
    (GEOM_SPHERE, GEOM_CYLINDER): (_b_sphere_cylinder, 1),
    (GEOM_SPHERE, GEOM_MESH): (_b_sphere_mesh, 1),
}
_GROUPED.update({k: (_b_support_pair, 4) for k, n in _PAIR_SLOTS.items()
                 if n == 4 and GEOM_PLANE not in k and GEOM_HEIGHTMAP not in k})


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

  The plane and heightmap pairs and the pairs of _GROUPED run grouped by
  type, the sphere pairs one by one; the broad phase's mask is ANDed into
  the `active` of every pair of two bounded geoms. All slots are restored
  to the canonical per-pair slot order by one static permutation, so the
  solver's row order (the Gauss-Seidel sweep order) is the JAX package's."""
  from raisimlib_torch.ops import heightmap as hm

  B = kin.p.shape[0]
  dtype, dev = kin.p.dtype, kin.p.device
  slot_of_pair = []
  body_a, body_b, mat_a, mat_b = [], [], [], []
  total = 0
  for ia, ib in pairs:
    key = (geoms.gtype[ia], geoms.gtype[ib])
    on_field = key[1] == GEOM_HEIGHTMAP and tuple(sorted(key)) in _PAIR_SLOTS
    if key not in _BATCHED and key not in SINGLE and key not in _GROUPED and not on_field:
      raise _no_narrow_phase(*key)
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
  groups = {}
  singles = []
  for pi, (ia, ib) in enumerate(pairs):
    key = (geoms.gtype[ia], geoms.gtype[ib])
    if key in _BATCHED or key in _GROUPED or key[1] == GEOM_HEIGHTMAP:
      groups.setdefault(key, []).append((pi, ia, ib))
    else:
      singles.append((pi, ia, ib))

  pos_c, nrm_c, dep_c, act_c = [], [], [], []
  computed = []
  bp = broadphase_mask(geoms, [(ia, ib) for _, ia, ib in singles], kin)
  for (pi, ia, ib), m in zip(singles, bp):
    for si, (pos, nrm, dep, val) in enumerate(
        SINGLE[(geoms.gtype[ia], geoms.gtype[ib])](geoms, ia, ib, kin)):
      pos_c.append(pos[:, None])
      nrm_c.append(nrm[:, None])
      dep_c.append(dep[:, None])
      act_c.append((val & m)[:, None].to(dtype))
      computed.append(slot_of_pair[pi] + si)
  for key, entries in groups.items():
    members = [(ia, ib) for _, ia, ib in entries]
    if key[1] == GEOM_HEIGHTMAP:
      ns = _PAIR_SLOTS[tuple(sorted(key))]
      pos, nrm, dep, val = hm.collide_group(geoms, [ia for ia, _ in members], kin, heightmap)
    elif key in _BATCHED:
      fn, ns = _BATCHED[key]
      pos, nrm, dep, val = fn(geoms, members, kin)
    else:
      fn, ns = _GROUPED[key]
      pos, nrm, dep, val = fn(geoms, members, kin)
      near = _overlap(_aabb(geoms, [ia for ia, _ in members], kin),
                      _aabb(geoms, [ib for _, ib in members], kin), 0.0)
      val = val & near[..., None]
      pos, nrm, dep, val = (x.reshape((B, -1) + x.shape[3:]) for x in (pos, nrm, dep, val))
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
