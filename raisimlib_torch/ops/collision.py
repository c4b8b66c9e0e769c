"""Collision detection over a static pair list, batched over worlds.

Counterpart of raisimlib_tpu/ops/collision.py, restricted to the pairs of the
plane-contact main path: sphere, box and capsule against the ground plane.
Every other pair type is rejected when the scene is built (candidate_pairs)
and again by `collide`, with an error that names it.

Contact convention: the normal points from geom B towards geom A; relative
velocity is v(A) - v(B) at the contact point; depth > 0 means penetration.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

GEOM_SPHERE = 0
GEOM_BOX = 1
GEOM_CAPSULE = 2
GEOM_PLANE = 3
GEOM_HEIGHTMAP = 4
GEOM_CYLINDER = 5
GEOM_MESH = 6
GEOM_CONE = 7

GEOM_NAMES = {GEOM_SPHERE: "sphere", GEOM_BOX: "box", GEOM_CAPSULE: "capsule",
              GEOM_PLANE: "plane", GEOM_HEIGHTMAP: "heightmap",
              GEOM_CYLINDER: "cylinder", GEOM_MESH: "mesh", GEOM_CONE: "cone"}

# slots contributed per ported pair type (keyed by sorted gtype pair)
_PAIR_SLOTS = {
    (GEOM_SPHERE, GEOM_PLANE): 1,
    (GEOM_BOX, GEOM_PLANE): 8,
    (GEOM_CAPSULE, GEOM_PLANE): 2,
}


def _unported(ta: int, tb: int) -> NotImplementedError:
  return NotImplementedError(
      f"geom pair ({GEOM_NAMES.get(ta, ta)}, {GEOM_NAMES.get(tb, tb)}) has no "
      f"narrow phase in raisimlib_torch yet (ported: sphere/box/capsule vs "
      f"plane); see ROADMAP.md, 'Runtime-frame pairs' and 'Rest of collision'")


@dataclasses.dataclass(frozen=True)
class GeomSpec:
  """One collision geom as World accumulates it (World's _GeomSpec)."""

  body: int           # merged-model body index; -1 = static world
  gtype: int
  params: np.ndarray  # (4,) sphere r; box hx,hy,hz; capsule r,hl; plane h
  offset_pos: np.ndarray
  offset_rot: np.ndarray
  material: int
  obj: int = -1       # owning object id; same-obj pairs skipped unless self_collision


@dataclasses.dataclass(frozen=True)
class GeomTable:
  """Numeric geom parameters + static type/body metadata."""

  gtype: tuple
  body: tuple
  material: tuple
  params: torch.Tensor      # (ng, 4)
  offset_pos: torch.Tensor  # (ng, 3)
  offset_rot: torch.Tensor  # (ng, 3, 3)


def build_geom_table(specs: Sequence[GeomSpec], dtype=torch.float32,
                     device="cpu") -> GeomTable:
  ng = len(specs)
  params = np.zeros((ng, 4))
  opos = np.zeros((ng, 3))
  orot = np.zeros((ng, 3, 3))
  for i, g in enumerate(specs):
    params[i] = g.params
    opos[i] = g.offset_pos
    orot[i] = g.offset_rot

  def t(x):
    return torch.as_tensor(x, dtype=dtype, device=device)

  return GeomTable(gtype=tuple(int(g.gtype) for g in specs),
                   body=tuple(int(g.body) for g in specs),
                   material=tuple(int(g.material) for g in specs),
                   params=t(params), offset_pos=t(opos), offset_rot=t(orot))


def candidate_pairs(specs: Sequence[GeomSpec], model, self_collision: bool = False) -> tuple:
  """Static candidate pair list (ia, ib), same filter and canonical order as
  the JAX package: no same-body, parent-child, same-object (unless
  self_collision) or static-static pairs; the plane comes second."""
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
      pairs.append((j, i) if ti == GEOM_PLANE else (i, j))
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
# the single-pair forms, slot for slot the same as the grouped ones
SINGLE = {
    (GEOM_SPHERE, GEOM_PLANE): _sphere_plane,
    (GEOM_BOX, GEOM_PLANE): _box_plane,
    (GEOM_CAPSULE, GEOM_PLANE): _capsule_plane,
}


def collide(geoms: GeomTable, pairs: tuple, kin, heightmap=None) -> ContactSet:
  """Run all pair kernels and assemble the padded ContactSet.

  Pairs are computed group by type and restored to the canonical per-pair
  slot order by one static permutation, so the solver's row order
  (the Gauss-Seidel sweep order) is the JAX package's."""
  if heightmap is not None:
    raise NotImplementedError(
        "heightmap terrain is not ported to raisimlib_torch yet: ROADMAP.md, "
        "'Heightmap and trot'")
  B = kin.p.shape[0]
  dtype, dev = kin.p.dtype, kin.p.device
  slot_of_pair = []
  body_a, body_b, mat_a, mat_b = [], [], [], []
  total = 0
  for ia, ib in pairs:
    key = (geoms.gtype[ia], geoms.gtype[ib])
    if key not in _BATCHED:
      raise _unported(*key)
    ns = _PAIR_SLOTS[tuple(sorted(key))]
    slot_of_pair.append(total)
    total += ns
    body_a += [geoms.body[ia]] * ns
    body_b += [geoms.body[ib]] * ns
    mat_a += [geoms.material[ia]] * ns
    mat_b += [geoms.material[ib]] * ns

  # every ported pair is a body-attached geom against the static plane
  # (candidate_pairs skips static-static pairs), so all run grouped
  groups = {}
  for pi, (ia, ib) in enumerate(pairs):
    groups.setdefault((geoms.gtype[ia], geoms.gtype[ib]), []).append((pi, ia, ib))

  pos_c, nrm_c, dep_c, act_c = [], [], [], []
  computed = []
  for key, entries in groups.items():
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
