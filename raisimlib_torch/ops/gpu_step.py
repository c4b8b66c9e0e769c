"""Fused full physics step (K1): one CUDA kernel launch per step, and its twin.

Counterpart of raisimlib_tpu/ops/pallas_step.py for all of its scene
classes: FREE, REVOLUTE, PRISMATIC and SPHERICAL joints and joint-limit rows,
with sphere centres, capsule endpoints and box corners as contact points
against the ground plane (K1a, `plane_pt` slots), a sphere against a sphere,
a box or a capsule, each on a body or static (K1b, `ss`, `sb` and `sc` slots:
collision's pair kernels, the sphere-box interior branch included), and
probes against a heightmap (K1c: `hm_pt` slots, heightmap._point_contact
with the riser march; `hm_cylpt` and `hm_conept` slots, the rim and apex
points of a cylinder or a cone in its runtime downhill frame; `hm_mesh`
slots, the 4 deepest hull-vertex probes of a convex mesh, selected in the
kernel). Per world the step runs

    A.   feedforward + implicit PD torque, clamped
    B/C. forward kinematics and the RNEA bias h
    D.   the CRBA mass matrix (+ dt kd on the diagonal) and its Cholesky factor
    E.   contact rows (plane: static frame t1 = +y, t2 = -x, n = +z; heightmap
         and sphere pairs: the runtime normal and pipeline._tangent_frames'
         frame; the Jacobian of v(A) - v(B)) and limit rows
    F.   triangular solves of [J^T | rhs0]: the rows of W = J M^-1 and v_free
    G.   the hoisted 3x3 blocks Gii and c0 of each cone, and of each limit row
    H.   Gauss-Seidel sweeps over the cones (exact cone solve), then the limits
    I.   semi-implicit integration with the quaternion exp-map

`_analyze` turns a Scene into static data on the host (numpy). The phases are
written once, in the JAX emitter's scalar algebra: Python-float constants
fold in float64 and structural zeros vanish, so only the operations that the
model's structure needs are emitted. The algebra runs over a small value
interface (`_Val`) with two back ends:

  * `_TorchOps`: a per-world scalar is a (B,) tensor. This gives the plain
    twin `_fused_plain`, which the tests, chip_smoke.py's comparison and CPU
    tensors use. It follows the dtype of its inputs.
  * `_CudaOps`: each operation prints one CUDA statement into a named
    temporary. This gives the body of the kernel, which csrc/fused_step.cuh
    frames (LANES = 8 lanes of a warp per world, or WIDE = 32 where the
    batch leaves the card mostly empty: `lanes_for`) and `_build` compiles
    for sm_90a. The lanes run the serial chain alike and split its parallel
    parts in lane regions: phase F's right-hand columns, the cone solve's
    angular grid, and the entries of z in the W updates, over the world's
    shared memory (`_smem_layout`). Only the lane that computes a value
    changes, not its expression.

The kernel and its twin therefore run the same sequence of operations, and
both stay diffable phase by phase against the JAX emitter. A folded constant
enters float32 arithmetic once, rounded (the kernel prints it already rounded
to float32). Both back ends tally the operations they run per world, loop
bodies times their trip counts; chip_smoke.py's bound for the kernel uses the
kernel's tally.

On a heightmap the kernel reads each world's heights directly: each lane
loads the heights of the cells its probes land in (`_emit_hm_probe`), from a
(B, nx, ny) tensor whose world stride is 0 when every world shares the
scene's field. The TPU kernel instead cut a root-centred patch per world in
its wrapper, since a TPU kernel has no vector gather; here the probe
computes heightmap.surface_at's full-field formula.

`make_step_batch_fused` is the public entry: CUDA tensors launch the kernel
(or raise), CPU tensors run the twin, and gradients differentiate
`pipeline.step_batch` (with the same heights), as the JAX package's custom
VJP does.
"""

from __future__ import annotations

import collections
import ctypes
import math
import re
from typing import NamedTuple

import numpy as np
import torch

from raisimlib_torch import _build
from raisimlib_torch.models.model import JointType
from raisimlib_torch.ops import collision as coll
from raisimlib_torch.ops import constraints as cs
from raisimlib_torch.ops import dynamics, gpu_contact, pipeline
from raisimlib_torch.ops.integrator import State
from raisimlib_torch.utils import profiling


class FusedStepUnsupported(Exception):
  """Scene outside the fused kernel's supported class; use the K2 path."""


# The kernel's shape: LANES lanes of a warp per world (FS_LANES), or WIDE
# (one world a block) where the batch fits the card in one wave
# (`lanes_for`), one warp per block; a block may hold at most
# SMEM_BLOCK_LIMIT bytes of shared memory (227 KB on an H100, dynamic above
# 48 KB). An SM holds SM_SMEM bytes of its blocks' shared memory, each block
# 1 KB more than it asks for, and at most SM_BLOCKS blocks; its warps issue
# from SM_SCHEDULERS schedulers. The kernel compiles with --fmad=false
# (_FLAGS): its FMAs are written in its source (`_fuse_products`), so that
# its two builds round alike.
LANES = 8
WIDE = 32
BLOCK = 32
SMEM_BLOCK_LIMIT = 232448
SM_SMEM = 233472
SM_BLOCKS = 32
SM_SCHEDULERS = 4
_FLAGS = ("--fmad=false",)


# ---------------------------------------------------------------------------
# Scalar algebra: a "scalar" is a Python float (static) or a `_Val` (one
# runtime value per world). Static zeros and ones fold away.
# ---------------------------------------------------------------------------


def _is_c(x) -> bool:
  return isinstance(x, (int, float))


def _mul(a, b):
  if _is_c(a) and _is_c(b):
    return float(a) * float(b)
  if _is_c(a):
    if a == 0.0:
      return 0.0
    if a == 1.0:
      return b
    if a == -1.0:
      return -b
    return a * b
  if _is_c(b):
    return _mul(b, a)
  return a * b


def _add2(a, b):
  if _is_c(a):
    if a == 0.0:
      return b
    if _is_c(b):
      return float(a) + float(b)
  if _is_c(b) and b == 0.0:
    return a
  return a + b


def _add(*xs):
  out = 0.0
  for x in xs:
    out = _add2(out, x)
  return out


def _neg(a):
  return -float(a) if _is_c(a) else -a


def _sub(a, b):
  return _add2(a, _neg(b))


def _dot(u, v):
  return _add(*[_mul(a, b) for a, b in zip(u, v)])


def _vadd(u, v):
  return tuple(_add2(a, b) for a, b in zip(u, v))


def _vsub(u, v):
  return tuple(_sub(a, b) for a, b in zip(u, v))


def _vscale(s, u):
  return tuple(_mul(s, a) for a in u)


def _cross(u, v):
  return (
      _sub(_mul(u[1], v[2]), _mul(u[2], v[1])),
      _sub(_mul(u[2], v[0]), _mul(u[0], v[2])),
      _sub(_mul(u[0], v[1]), _mul(u[1], v[0])),
  )


def _mv(M, v):
  """3x3 @ 3."""
  return tuple(_dot(row, v) for row in M)


def _mTv(M, v):
  """3x3 transpose @ 3."""
  return tuple(_dot((M[0][j], M[1][j], M[2][j]), v) for j in range(3))


def _mm(A, B):
  """3x3 @ 3x3."""
  return tuple(
      tuple(_dot(A[i], tuple(B[k][j] for k in range(3))) for j in range(3))
      for i in range(3))


def _mT(A):
  return tuple(tuple(A[j][i] for j in range(3)) for i in range(3))


def _m_add(A, B):
  return tuple(tuple(_add2(a, b) for a, b in zip(ra, rb))
               for ra, rb in zip(A, B))


def _skew(v):
  return ((0.0, _neg(v[2]), v[1]),
          (v[2], 0.0, _neg(v[0])),
          (_neg(v[1]), v[0], 0.0))


_ZV = (0.0, 0.0, 0.0)
_Z3 = (_ZV, _ZV, _ZV)
_I3 = ((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0))


def _np_m(M):
  return tuple(tuple(float(x) for x in row) for row in np.asarray(M))


def _np_v(v):
  return tuple(float(x) for x in np.asarray(v))


# 6-vectors as (vec3, vec3) pairs; 6x6 as (A, B, C, D) 3x3 blocks.


def _xf_motion(E, r, wv):
  """Motion vector A-coords -> B-coords for X = (E, r)."""
  w, v = wv
  return (_mv(E, w), _mv(E, _vsub(v, _cross(r, w))))


def _xf_motion_inv(E, r, wv):
  """Motion vector B-coords -> A-coords."""
  w, v = wv
  wp = _mTv(E, w)
  return (wp, _vadd(_mTv(E, v), _cross(r, wp)))


def _xf_force_inv(E, r, nf):
  """Force vector B-coords -> A-coords."""
  n, f = nf
  fp = _mTv(E, f)
  return (_vadd(_mTv(E, n), _cross(r, fp)), fp)


def _cross_motion(v, m):
  w, vl = v
  mw, ml = m
  return (_cross(w, mw), _vadd(_cross(w, ml), _cross(vl, mw)))


def _cross_force(v, f):
  w, vl = v
  n, fl = f
  return (_vadd(_cross(w, n), _cross(vl, fl)), _cross(w, fl))


def _I_mul(I4, wv):
  """6x6 (A,B,C,D blocks) @ motion (w, v)."""
  A, B, C, D = I4
  w, v = wv
  return (_vadd(_mv(A, w), _mv(B, v)), _vadd(_mv(C, w), _mv(D, v)))


def _vadd6(*wvs):
  w = (0.0, 0.0, 0.0)
  v = (0.0, 0.0, 0.0)
  for ww, vv in wvs:
    w = _vadd(w, ww)
    v = _vadd(v, vv)
  return (w, v)


def _b_mm(X, Y):
  """6x6 block matmul: (A,B,C,D) @ (A,B,C,D)."""
  XA, XB, XC, XD = X
  YA, YB, YC, YD = Y
  return (_m_add(_mm(XA, YA), _mm(XB, YC)), _m_add(_mm(XA, YB), _mm(XB, YD)),
          _m_add(_mm(XC, YA), _mm(XD, YC)), _m_add(_mm(XC, YB), _mm(XD, YD)))


def _b_T(X):
  A, B, C, D = X
  return (_mT(A), _mT(C), _mT(B), _mT(D))


def _b_add(X, Y):
  return tuple(_m_add(a, b) for a, b in zip(X, Y))


def _quat_to_mat(qw, qx, qy, qz):
  xx, yy, zz = _mul(qx, qx), _mul(qy, qy), _mul(qz, qz)
  xy, xz, yz = _mul(qx, qy), _mul(qx, qz), _mul(qy, qz)
  wx, wy, wz = _mul(qw, qx), _mul(qw, qy), _mul(qw, qz)
  return (
      (_sub(1.0, _mul(2.0, _add2(yy, zz))), _mul(2.0, _sub(xy, wz)),
       _mul(2.0, _add2(xz, wy))),
      (_mul(2.0, _add2(xy, wz)), _sub(1.0, _mul(2.0, _add2(xx, zz))),
       _mul(2.0, _sub(yz, wx))),
      (_mul(2.0, _sub(xz, wy)), _mul(2.0, _add2(yz, wx)),
       _sub(1.0, _mul(2.0, _add2(xx, yy)))),
  )


def _rodrigues(axis, c, s):
  """R = I + s K + (1-c) K^2 for a STATIC unit axis; c, s runtime."""
  K = _skew(axis)
  KK = _mm(K, K)
  one_c = _sub(1.0, c)
  return tuple(
      tuple(_add(_I3[i][j], _mul(s, K[i][j]), _mul(one_c, KK[i][j]))
            for j in range(3)) for i in range(3))


# ---------------------------------------------------------------------------
# Static scene analysis
# ---------------------------------------------------------------------------


class _Slot(NamedTuple):
  """One contact slot. A side: a feature point or sphere centre at the static
  offset `local` in body_a's frame (body_a = -1: the world frame), with a
  sphere radius (0 for a box corner). `kind` selects the narrow phase:

    "plane_pt": against the static plane z = plane_h, with the static
                contact frame t1 = +y, t2 = -x, n = +z;
    "hm_pt":    against the heightmap, with the probe's runtime normal;
    "ss":       against a sphere of radius rb at offset b_pos on body_b;
    "sb":       against a box of half extents he at (b_pos, b_rot) on body_b,
                the interior branch included (collision._sphere_box);
    "sc":       against a capsule at (b_pos, b_rot) on body_b, he = (rb, hl,
                0) (collision._sphere_capsule);
    "hm_cylpt": a rim point of a cylinder at (b_pos, b_rot) on body_a, he =
                (r, hl, 0), against the heightmap: local = (cap sign, phi,
                0), phi the angle from the runtime downhill direction;
    "hm_conept": a point of a cone at (b_pos, b_rot) on body_a, he = (r, h,
                0): local = (0, 0, 0) the apex, (1, phi, 0) a base-rim point;
    "hm_mesh":  the k-th deepest hull-vertex probe of mesh hm_meshes[i] on
                body_a against the heightmap: local = (i, k, 0).

  body_b = -1 for the plane, the heightmap and a static world geom, whose
  b_pos and b_rot are then world coordinates. The sphere pairs and the
  heightmap slots take their frame from the runtime normal."""

  kind: str
  body_a: int
  body_b: int
  local: tuple
  radius: float
  plane_h: float
  rb: float
  he: tuple
  b_pos: tuple
  b_rot: tuple
  mu: float
  e: float
  thresh: float


class _Limit(NamedTuple):
  vadr: int
  qadr: int
  lo: float
  hi: float


class _HmStatic(NamedTuple):
  """The heightfield's static constants. A probe at x has fx = (x - cx + hx)
  / dx, cell i = floor(fx) clipped to [0, nx - 2], as heightmap.surface_at;
  the heights themselves are a runtime input."""

  nx: int
  ny: int
  dx: float
  dy: float
  cx: float             # the field's centre
  cy: float
  hx: float             # half its extent, size_x / 2
  hy: float


class _StaticData(NamedTuple):
  """Everything the kernel needs, concretized to Python/numpy at build time."""

  # model
  nb: int
  nq: int
  nv: int
  parent: tuple
  joint_types: tuple
  q_adr: tuple
  v_adr: tuple
  axis: tuple           # per body, static 3-tuple
  X_rotT: tuple         # per body, static 3x3 (transpose of parent->joint rot)
  X_rot: tuple
  X_pos: tuple
  I6: tuple             # per body, (A, B, C, D) static 3x3 blocks
  anc_dofs: tuple       # per body, tuple of ancestor dof indices
  # actuation
  actuated: tuple
  torque_limit: tuple
  kp: tuple
  kd: tuple
  jidx: tuple           # dof -> qpos index for 1-dof joints
  jmask: tuple
  use_pd: bool
  # physics
  dt: float
  gravity: tuple
  erp: float
  slop: float
  max_corr: float
  sweeps: int
  n_grid: int
  # rows
  slots: tuple          # of _Slot
  limits: tuple         # of _Limit
  n_wrows: int          # solver rows needing W (3 * ncone + nlim)
  hm: _HmStatic = None  # the heightfield, for scenes with "hm_*" slots
  hm_meshes: tuple = ()  # (body, vertices (body frame), vertex count) per mesh


def _host(x) -> np.ndarray:
  return x.detach().cpu().double().numpy()


_UNSUPPORTED_PAIR = ("box-box, capsule-capsule, sphere-cylinder, sphere-mesh and the "
                     "support-function pairs are outside the fused kernel's class, as in "
                     "the JAX package's _analyze: such a scene steps on the K2 path "
                     "(Scene.step_batch)")


def _analyze_field(scene, field) -> _HmStatic:
  """The field's static constants; FusedStepUnsupported where the JAX
  package's `_analyze_field` raises: heights not (nx, ny) at build time, a
  field-colliding geom not below a FREE root or below an unlimited prismatic
  joint, and a field that no geom collides with."""
  model = scene.model
  tabs = scene.constraints or cs.EMPTY
  if field.heights.ndim != 2:
    raise FusedStepUnsupported("field.heights must be (nx, ny) at build time")
  nx, ny = field.heights.shape
  limited = {int(v) for v in tabs.limit_vadr}
  hm_geom = scene.geoms.gtype.index(coll.GEOM_HEIGHTMAP)
  colliding = False
  for ia, ib in scene.pairs:
    if hm_geom not in (ia, ib):
      continue
    colliding = True
    b = scene.geoms.body[ia if ib == hm_geom else ib]
    if b < 0:
      raise FusedStepUnsupported("heightmap-colliding geom not attached below the FREE root")
    while model.parent[b] >= 0:
      if (JointType(model.joint_types[b]) == JointType.PRISMATIC
          and int(model.v_adr[b]) not in limited):
        raise FusedStepUnsupported("unlimited prismatic joint above a "
                                   "heightmap-colliding geom (no static reach bound)")
      b = int(model.parent[b])
    if JointType(model.joint_types[b]) != JointType.FREE:
      raise FusedStepUnsupported("heightmap-colliding geoms must descend from a FREE root")
  if not colliding:
    raise FusedStepUnsupported("heightmap present but no colliding pairs")
  cx, cy = (float(c) for c in _host(field.center))
  return _HmStatic(nx=nx, ny=ny, dx=float(field.size_x) / (nx - 1),
                   dy=float(field.size_y) / (ny - 1), cx=cx, cy=cy,
                   hx=0.5 * float(field.size_x), hy=0.5 * float(field.size_y))


def _analyze(scene, config, use_pd: bool) -> _StaticData:
  """Concretize the scene to static kernel data; raise FusedStepUnsupported
  for anything outside the kernel's scene classes (K1a "plane_pt", K1b "ss",
  "sb", "sc", K1c "hm_pt", "hm_cylpt", "hm_conept", "hm_mesh"), in the
  JAX package's slot order and with its slot fields."""
  model = scene.model
  for jt in model.joint_types:
    if JointType(jt) not in (JointType.FREE, JointType.REVOLUTE,
                             JointType.PRISMATIC, JointType.SPHERICAL):
      raise FusedStepUnsupported(f"joint type {JointType(jt)!r}")
  tabs = scene.constraints or cs.EMPTY
  if tabs.wires or tabs.pins or tabs.compliant:
    raise FusedStepUnsupported("wires, pins and compliant wires are outside the fused "
                               "kernel's class, as in the JAX package's _analyze: such a "
                               "scene steps on the K2 path (Scene.step_batch)")
  geoms = scene.geoms
  field = getattr(scene, "field", None)
  hm = _analyze_field(scene, field) if field is not None else None
  mats = _host(scene.materials)
  params = _host(geoms.params)
  opos = _host(geoms.offset_pos)
  orot = _host(geoms.offset_rot)

  slots = []
  hm_meshes = []
  for ia, ib in scene.pairs:
    ta, tb = geoms.gtype[ia], geoms.gtype[ib]
    names = (coll.GEOM_NAMES.get(ta, ta), coll.GEOM_NAMES.get(tb, tb))
    ba, bb = geoms.body[ia], geoms.body[ib]
    mu, e, th = (float(x) for x in mats[geoms.material[ia], geoms.material[ib]])
    pa, oa, ra_ = params[ia], opos[ia], orot[ia]
    pb, ob, rb_ = params[ib], opos[ib], orot[ib]
    # the sphere pairs, exactly as the JAX package's _analyze emits them
    if (ta, tb) == (coll.GEOM_SPHERE, coll.GEOM_SPHERE):
      slots.append(_Slot("ss", ba, bb, _np_v(oa), float(pa[0]), 0.0, float(pb[0]), _ZV,
                         _np_v(ob), _I3, mu, e, th))
      continue
    if (ta, tb) == (coll.GEOM_SPHERE, coll.GEOM_BOX):
      slots.append(_Slot("sb", ba, bb, _np_v(oa), float(pa[0]), 0.0, 0.0, _np_v(pb[:3]),
                         _np_v(ob), _np_m(rb_), mu, e, th))
      continue
    if (ta, tb) == (coll.GEOM_SPHERE, coll.GEOM_CAPSULE):
      slots.append(_Slot("sc", ba, bb, _np_v(oa), float(pa[0]), 0.0, float(pb[0]),
                         (float(pb[0]), float(pb[1]), 0.0), _np_v(ob), _np_m(rb_),
                         mu, e, th))
      continue
    if tb == coll.GEOM_HEIGHTMAP:
      kind, h = "hm_pt", 0.0
    elif tb == coll.GEOM_PLANE:
      kind, h = "plane_pt", float(params[ib, 0])
    else:
      raise FusedStepUnsupported(f"pair {names}: {_UNSUPPORTED_PAIR}")
    if ba < 0:
      raise FusedStepUnsupported(f"static non-plane geom vs {names[1]}")

    def point(local, radius):
      slots.append(_Slot(kind, ba, -1, _np_v(local), float(radius), h, 0.0, _ZV,
                         _ZV, _I3, mu, e, th))

    # slot counts and order as collision's plane kernels and
    # heightmap.collide_group
    if ta == coll.GEOM_SPHERE:
      point(oa, pa[0])
    elif ta == coll.GEOM_CAPSULE:
      # two endpoint spheres at static body-local points
      r_, hl = float(pa[0]), float(pa[1])
      for s_ in (-1.0, 1.0):
        point(oa + ra_ @ np.array([0.0, 0.0, s_ * hl]), r_)
    elif ta == coll.GEOM_BOX:
      he = pa[:3]
      for sx in (-1.0, 1.0):
        for sy in (-1.0, 1.0):
          for sz in (-1.0, 1.0):
            point(oa + ra_ @ (he * np.array([sx, sy, sz])), 0.0)
    elif kind == "hm_pt" and ta in (coll.GEOM_CYLINDER, coll.GEOM_CONE):
      # probes at runtime offsets (the downhill frame), in the order of
      # heightmap's cylinder and cone points
      he = (float(pa[0]), float(pa[1]), 0.0)
      if ta == coll.GEOM_CYLINDER:
        kind, locals_ = "hm_cylpt", [(s_, phi, 0.0) for s_ in (-1.0, 1.0)
                                     for phi in coll.RIM_PHI]
      else:
        kind, locals_ = "hm_conept", [_ZV] + [(1.0, phi, 0.0) for phi in coll.RIM_PHI]
      for loc in locals_:
        slots.append(_Slot(kind, ba, -1, loc, 0.0, 0.0, 0.0, he, _np_v(oa), _np_m(ra_),
                           mu, e, th))
    elif kind == "hm_pt" and ta == coll.GEOM_MESH:
      # the 4 deepest of the hull-vertex probes, selected in the kernel
      vcount = int(geoms.mesh_vcount[ia])
      verts = _host(geoms.mesh_verts[ia])[:vcount]
      hm_meshes.append((ba, tuple(_np_v(v) for v in verts), vcount))
      for k in range(4):
        slots.append(_Slot("hm_mesh", ba, -1, (float(len(hm_meshes) - 1), float(k), 0.0),
                           0.0, 0.0, 0.0, _ZV, _ZV, _I3, mu, e, th))
    else:
      raise FusedStepUnsupported(f"geom type {names[0]} vs {names[1]}")

  limits = tuple(
      _Limit(int(v), int(q), float(lo), float(hi))
      for v, q, lo, hi in zip(tabs.limit_vadr, tabs.limit_qadr,
                              tabs.limit_lo, tabs.limit_hi))

  if use_pd and scene.kp is None:
    raise FusedStepUnsupported("use_pd=True but scene has no PD gains")

  amask = dynamics.ancestor_dof_mask(model)
  anc = tuple(tuple(int(j) for j in np.nonzero(amask[b])[0])
              for b in range(model.nb))
  jidx, jmask = pipeline._joint_pos_index(model)

  inr = _host(model.inertia)
  I6 = tuple((_np_m(inr[b, :3, :3]), _np_m(inr[b, :3, 3:]),
              _np_m(inr[b, 3:, :3]), _np_m(inr[b, 3:, 3:]))
             for b in range(model.nb))
  kp = _host(scene.kp) if scene.kp is not None else np.zeros(model.nv)
  kd = _host(scene.kd) if scene.kd is not None else np.zeros(model.nv)
  X_rot, X_pos, axis = _host(model.X_rot), _host(model.X_pos), _host(model.axis)

  return _StaticData(
      nb=model.nb, nq=model.nq, nv=model.nv,
      parent=tuple(model.parent),
      joint_types=tuple(JointType(j) for j in model.joint_types),
      q_adr=tuple(model.q_adr), v_adr=tuple(model.v_adr),
      axis=tuple(_np_v(axis[b]) for b in range(model.nb)),
      X_rotT=tuple(_np_m(X_rot[b].T) for b in range(model.nb)),
      X_rot=tuple(_np_m(X_rot[b]) for b in range(model.nb)),
      X_pos=tuple(_np_v(X_pos[b]) for b in range(model.nb)),
      I6=I6, anc_dofs=anc,
      actuated=_np_v(_host(model.actuated)),
      torque_limit=_np_v(_host(model.torque_limit)),
      kp=_np_v(kp), kd=_np_v(kd),
      jidx=tuple(int(x) for x in jidx), jmask=_np_v(jmask),
      use_pd=use_pd,
      dt=float(scene.dt), gravity=_np_v(_host(scene.gravity)),
      erp=float(config.erp), slop=float(config.slop),
      max_corr=float(config.max_correction_vel),
      sweeps=int(config.solver.sweeps), n_grid=int(config.solver.n_grid),
      slots=tuple(slots), limits=limits,
      n_wrows=3 * len(slots) + len(limits), hm=hm, hm_meshes=tuple(hm_meshes))


# ---------------------------------------------------------------------------
# Runtime values and the two back ends
# ---------------------------------------------------------------------------

_BOOL_OPS = (">", "<", ">=", "<=", "==", "||", "&&")


class _Val:
  """One runtime scalar per world: a tensor in the twin, the name of a CUDA
  temporary in the kernel source. Arithmetic goes to the back end `k`."""

  __slots__ = ("k", "x")

  def __init__(self, k, x):
    self.k, self.x = k, x

  def __add__(self, o):
    return self.k.bin("+", self, o)

  def __radd__(self, o):
    return self.k.bin("+", o, self)

  def __sub__(self, o):
    return self.k.bin("-", self, o)

  def __rsub__(self, o):
    return self.k.bin("-", o, self)

  def __mul__(self, o):
    return self.k.bin("*", self, o)

  def __rmul__(self, o):
    return self.k.bin("*", o, self)

  def __truediv__(self, o):
    return self.k.bin("/", self, o)

  def __rtruediv__(self, o):
    return self.k.bin("/", o, self)

  def __neg__(self):
    return self.k.neg(self)

  def __gt__(self, o):
    return self.k.bin(">", self, o)

  def __lt__(self, o):
    return self.k.bin("<", self, o)

  def __ge__(self, o):
    return self.k.bin(">=", self, o)

  def __le__(self, o):
    return self.k.bin("<=", self, o)

  def __or__(self, o):
    return self.k.bin("||", self, o)

  def __and__(self, o):
    return self.k.bin("&&", self, o)

  def __invert__(self):
    return self.k.not_(self)


class _TorchOps:
  """The twin's back end: a value is a (B,) tensor, or a (B, n) slab of n
  right-hand columns (phase F) or n dofs (the z update of phase H). `ops`
  counts operations per world: a slab operation counts n; `loads` counts the
  height loads per world. `heights` is the (B, nx, ny) terrain of a
  heightmap scene."""

  def __init__(self, B: int, dtype, device, heights=None):
    self.B, self.dtype, self.device = B, dtype, device
    self.heights = heights
    self.worlds = torch.arange(B, device=device)
    self.ops = 0
    self.loads = 0

  def t(self, v):
    """The tensor behind a value; a constant becomes a (B,) tensor."""
    if isinstance(v, _Val):
      return v.x
    return torch.full((self.B,), float(v), dtype=self.dtype, device=self.device)

  def _out(self, r):
    self.ops += r.shape[1] if r.ndim == 2 else 1
    return _Val(self, r)

  def bin(self, op, a, b):
    xa = a.x if isinstance(a, _Val) else float(a)
    xb = b.x if isinstance(b, _Val) else float(b)
    if torch.is_tensor(xa) and torch.is_tensor(xb) and xa.ndim != xb.ndim:
      if xa.ndim < xb.ndim:
        xa = xa[:, None]
      else:
        xb = xb[:, None]
    if op == "/":
      # tensor by tensor: PyTorch divides by a Python scalar as a product
      # with its reciprocal on the card, which is not IEEE division
      if not torch.is_tensor(xa):
        xa = torch.full_like(xb, xa)
      if not torch.is_tensor(xb):
        xb = torch.full_like(xa, xb)
      r = xa / xb
    elif op == "+":
      r = xa + xb
    elif op == "-":
      r = xa - xb
    elif op == "*":
      r = xa * xb
    elif op == ">":
      r = xa > xb
    elif op == "<":
      r = xa < xb
    elif op == ">=":
      r = xa >= xb
    elif op == "<=":
      r = xa <= xb
    elif op == "==":
      r = xa == xb
    elif op == "&&":
      r = xa & xb
    else:
      r = xa | xb
    return self._out(r)

  def neg(self, a):
    return self._out(-a.x)

  def not_(self, a):
    return self._out(~a.x)

  def floor(self, a):
    return self._out(torch.floor(self.t(a)))

  def abs(self, a):
    return self._out(torch.abs(self.t(a)))

  def cell_index(self, i, j):
    """The integer cell (i, j) of floored, clipped float indices (not an
    operation of the tally). The clamp only matters for a NaN index, which
    the kernel's fmaxf turns into 0."""
    nx, ny = self.heights.shape[-2:]
    return i.x.long().clamp(0, nx - 2), j.x.long().clamp(0, ny - 2)

  def height(self, cell, di: int, dj: int):
    """heights[b, i + di, j + dj] of each world b (a load, not an operation)."""
    self.loads += 1
    i, j = cell
    return _Val(self, self.heights[self.worlds, i + di, j + dj].to(self.dtype))

  def sqrt(self, a):
    return self._out(torch.sqrt(self.t(a)))

  def rsqrt(self, a):
    return self._out(torch.rsqrt(self.t(a)))

  def sin(self, a):
    return self._out(torch.sin(self.t(a)))

  def cos(self, a):
    return self._out(torch.cos(self.t(a)))

  def maximum(self, a, b):
    if _is_c(a):
      a, b = b, a
    if _is_c(b):
      return self._out(torch.clamp(a.x, min=float(b)))
    return self._out(torch.maximum(a.x, b.x))

  def minimum(self, a, b):
    if _is_c(a):
      a, b = b, a
    if _is_c(b):
      return self._out(torch.clamp(a.x, max=float(b)))
    return self._out(torch.minimum(a.x, b.x))

  def where(self, c, a, b):
    return self._out(torch.where(c.x, self.t(a), self.t(b)))

  def to_float(self, c):
    return self._out(c.x.to(self.dtype))

  def cells(self, name, n):
    return _TorchCells(self, n)

  def repeat(self, n, body):
    for _ in range(n):
      body()

  def pack(self, name, vals):
    return tuple(self.t(v) for v in vals)

  def cone_solve(self, g, c, mu: float, n_grid: int):
    ln = gpu_contact._cone_solve_grid(g, tuple(self.t(x) for x in c),
                                      self.t(mu), n_grid)
    self.ops += gpu_contact.cone_solve_ops(n_grid)
    return [_Val(self, x) for x in ln]

  def solve_columns(self, Jrows, rhs0, L, invd):
    """Phase F on (B, ncol) slabs, one per dof: columns 0..nw-1 hold J^T,
    column nw the rhs0 vector. Returns (W, vf column)."""
    nv, nw = len(rhs0), len(Jrows)
    cols = [torch.zeros((self.B, nw + 1), dtype=self.dtype, device=self.device)
            for _ in range(nv)]
    for row in range(nw):
      for j, val in Jrows[row].items():
        cols[j][:, row] = self.t(val)
    for j in range(nv):
      cols[j][:, nw] = self.t(rhs0[j])
    x = [_Val(self, c) for c in cols]
    _tri_solve(x, L, invd)
    X = torch.stack([v.x for v in x], -1)             # (B, nw + 1, nv)
    return _TorchRows(self, X[:, :nw]), [_Val(self, X[:, nw, j]) for j in range(nv)]

  def axpy(self, z, W, rows, ds):
    """z += sum_a W[rows[a]] * ds[a], elementwise over the dofs, in the
    order (W0 d0 + W1 d1) + W2 d2, then z + that."""
    acc = self._out(W.X[:, rows[0]] * self.t(ds[0])[:, None]).x
    for r, d in zip(rows[1:], ds[1:]):
      prod = self._out(W.X[:, r] * self.t(d)[:, None]).x
      acc = self._out(acc + prod).x
    zs = self._out(torch.stack(z.vals, 1) + acc).x
    z.vals = list(zs.unbind(1))


class _TorchCells:
  """Mutable per-world scalars (z, lambda) of the twin."""

  def __init__(self, k, n):
    self.k = k
    self.vals = [k.t(0.0) for _ in range(n)]

  def get(self, i):
    return _Val(self.k, self.vals[i])

  def set(self, i, v):
    self.vals[i] = self.k.t(v)


class _TorchRows:
  """The rows of W = J M^-1 in the twin: X (B, nw, nv)."""

  def __init__(self, k, X):
    self.k, self.X = k, X

  def elem(self, row, j):
    return _Val(self.k, self.X[:, row, j])


def _lit(c) -> str:
  """A float32 literal: the constant rounded to float32 once, printed with
  enough digits to read back exactly."""
  f = float(np.float32(c))
  if not math.isfinite(f):
    raise ValueError(f"constant {c} is not finite in float32")
  return f"{f:.9e}f"


class _CudaOps:
  """The kernel's back end: each operation prints one statement into a new
  temporary, which every lane of the world computes alike. Phase F, the cone
  solve's angular grid and the W updates print lane regions instead
  (FS_LANES_BEGIN ... FS_LANES_END: lane l takes the items l, l + FS_LANES,
  ...), over the world's shared arrays at the offsets `smem`
  (`_smem_layout`). `ops` counts operations per world, a loop body times its
  trip count, whichever lane runs it."""

  _FN = {"sqrt": "sqrtf", "rsqrt": "rsqrtf", "sin": "sinf", "cos": "cosf",
         "maximum": "fmaxf", "minimum": "fminf", "floor": "floorf", "abs": "fabsf"}

  def __init__(self, ny: int = 0, smem=None):
    self.lines = []
    self.n = 0
    self.ops = 0
    self.loads = 0
    self.mult = 1
    self.depth = 1
    self.ny = ny                # heightmap row length: heights[i, j] at hts[i * ny + j]
    self.smem = smem or {}      # shared array -> offset in the world's slice (floats)
    self.packed = 0             # Gii blocks packed so far

  def emit(self, line: str):
    self.lines.append("  " * self.depth + line)

  def e(self, v) -> str:
    return v.x if isinstance(v, _Val) else _lit(v)

  def _def(self, ctype, expr, count=True):
    name = f"t{self.n}"
    self.n += 1
    self.emit(f"{ctype} {name} = {expr};")
    if count:
      self.ops += self.mult
    return _Val(self, name)

  def bin(self, op, a, b):
    ctype = "bool" if op in _BOOL_OPS else "float"
    return self._def(ctype, f"{self.e(a)} {op} {self.e(b)}")

  def neg(self, a):
    return self._def("float", f"-{self.e(a)}")

  def not_(self, a):
    return self._def("bool", f"!{self.e(a)}")

  def cell_index(self, i, j):
    """The flat index of cell (i, j), from floored, clipped float indices (not
    an operation of the tally)."""
    name = f"c{self.n}"
    self.n += 1
    self.emit(f"const int {name} = (int){self.e(i)} * {self.ny} + (int){self.e(j)};")
    return name

  def height(self, cell, di: int, dj: int):
    """heights[i + di, j + dj] of this lane's world (a load, not an
    operation)."""
    self.loads += self.mult
    return self._def("float", f"__ldg(hts + {cell} + {di * self.ny + dj})", count=False)

  def floor(self, a):
    return self._fn("floor", a)

  def abs(self, a):
    return self._fn("abs", a)

  def _fn(self, name, *args):
    return self._def("float", f"{self._FN[name]}({', '.join(self.e(a) for a in args)})")

  def sqrt(self, a):
    return self._fn("sqrt", a)

  def rsqrt(self, a):
    return self._fn("rsqrt", a)

  def sin(self, a):
    return self._fn("sin", a)

  def cos(self, a):
    return self._fn("cos", a)

  def maximum(self, a, b):
    return self._fn("maximum", a, b)

  def minimum(self, a, b):
    return self._fn("minimum", a, b)

  def where(self, c, a, b):
    return self._def("float", f"{self.e(c)} ? {self.e(a)} : {self.e(b)}")

  def to_float(self, c):
    return self._def("float", f"{self.e(c)} ? 1.0f : 0.0f")

  def cells(self, name, n):
    """Mutable per-world values, zeroed: in the world's shared memory if the
    layout holds `name` (z, which the W updates' lane regions write), else
    in each lane's own array (lambda, which serial code writes)."""
    if name in self.smem:
      self.emit(f"float* const {name} = fs_smem + {self.smem[name]};")
      self._lanes_begin()
      self.emit(f"for (int k = l; k < {n}; k += FS_LANES) {name}[k] = 0.0f;")
      self._lanes_end()
      return _CudaCells(self, name, shared=True)
    self.emit(f"float {name}[{n}];")
    self.emit(f"for (int k = 0; k < {n}; ++k) {name}[k] = 0.0f;")
    return _CudaCells(self, name)

  def _lanes_begin(self):
    self.emit("FS_LANES_BEGIN")
    self.depth += 1

  def _lanes_end(self):
    self.depth -= 1
    self.emit("FS_LANES_END")

  def _loop(self, var, n, lanes=False):
    """A runtime loop over n items (a lane's share of them if `lanes`); the
    tally counts the body n times."""
    self.emit("#pragma unroll 1")
    if lanes:
      self.emit(f"for (int {var} = l; {var} < {n}; {var} += FS_LANES) {{")
    else:
      self.emit(f"for (int {var} = 0; {var} < {n}; ++{var}) {{")
    self.depth += 1
    self.mult *= n

  def _end_loop(self, n):
    self.mult //= n
    self.depth -= 1
    self.emit("}")

  def repeat(self, n, body):
    self._loop("sweep", n)
    body()
    self._end_loop(n)

  def pack(self, name, vals):
    """A cone's hoisted Gii entries as an array in the world's shared memory
    (written in a lane region), with each runtime value rebound to its
    shared copy: the sweeps then read the 6 ncone entries from there rather
    than hold them in registers across their loop."""
    off = self.smem["gii"] + 6 * self.packed
    self.packed += 1
    self.emit(f"float* const {name} = fs_smem + {off};")
    self._lanes_begin()
    for k, v in enumerate(vals):
      self.emit(f"if (l == {k} % FS_LANES) {name}[{k}] = {self.e(v)};")
    self._lanes_end()
    for k, v in enumerate(vals):
      if isinstance(v, _Val):
        v.x = f"{name}[{k}]"
    return name

  def cone_solve(self, g, c, mu: float, n_grid: int):
    """csrc/cone_solve.cuh's lane-split solve, its argmins reduced over the
    world's lanes."""
    name = f"ln{self.n}"
    self.n += 1
    self.emit(f"float {name}[3];")
    self.emit(f"rsl::cone_solve_lanes({g}, {', '.join(self.e(x) for x in c)}, {_lit(mu)}, "
              f"cc, fs_smem + {self.smem['trig']}, fs_lane, {name});")
    self.ops += self.mult * gpu_contact.cone_solve_ops(n_grid)
    return [_Val(self, f"{name}[{a}]") for a in range(3)]

  def solve_columns(self, Jrows, rhs0, L, invd):
    """Phase F in one lane region over the world's shared jt (column c at
    jt[c * nv]: the nw columns of J^T, then rhs0): lane l fills the columns c
    = l (mod FS_LANES) and solves each in place, its nv entries in
    registers. Each distinct runtime value of J also goes to a slot of the
    shared jr, and Jrows' entries are pointed there: phases G and H then
    read J from shared memory rather than hold it in registers across the
    sweeps. Returns (W, vf column)."""
    nv, nw = len(rhs0), len(Jrows)
    ncol = nw + 1
    slot = {}                                  # runtime J value -> its jr slot
    for row in Jrows:
      for val in row.values():
        if isinstance(val, _Val):
          slot.setdefault(val.x, len(slot))
    if len(slot) > self.smem["jr_size"]:
      raise AssertionError(f"{len(slot)} runtime J entries, room for {self.smem['jr_size']}")
    self.emit(f"float* const jt = fs_smem + {self.smem['jt']};")
    self.emit(f"float* const jr = fs_smem + {self.smem['jr']};")
    self._lanes_begin()
    self.emit(f"for (int c = l; c < {ncol}; c += FS_LANES)")
    self.emit(f"  for (int k = 0; k < {nv}; ++k) jt[c * {nv} + k] = 0.0f;")
    for c in range(ncol):
      entries = Jrows[c].items() if c < nw else enumerate(rhs0)
      self.emit(f"if (l == {c} % FS_LANES) {{")
      for j, val in entries:
        self.emit(f"  jt[{c * nv + j}] = {self.e(val)};")
      self.emit("}")
    for x, k in slot.items():
      self.emit(f"if (l == {k} % FS_LANES) jr[{k}] = {x};")
    for row in Jrows:
      for j, val in row.items():
        if isinstance(val, _Val):
          row[j] = _Val(self, f"jr[{slot[val.x]}]")
    self._loop("c", ncol, lanes=True)
    self.emit(f"float* col = jt + c * {nv};")
    x = [_Val(self, f"col[{i}]") for i in range(nv)]
    _tri_solve(x, L, invd)
    for i in range(nv):
      self.emit(f"col[{i}] = {self.e(x[i])};")
    self._end_loop(ncol)
    self._lanes_end()
    return _CudaRows(self, nv), [_Val(self, f"jt[{nw * nv + j}]") for j in range(nv)]

  def axpy(self, z, W, rows, ds):
    """z += sum_a W[rows[a]] * ds[a] in a lane region: lane l updates the
    entries k = l (mod FS_LANES) of the shared z, each in the twin's order,
    (W0 d0 + W1 d1) + W2 d2 with the later products fused (fmaf, as
    `_fuse_products` does), then z + that."""
    nv = W.nv
    terms = [(f"jt[{r * nv} + k]", self.e(d)) for r, d in zip(rows, ds)]
    self._lanes_begin()
    self.emit("#pragma unroll")                 # a constant trip count: the loads overlap
    self.emit(f"for (int i = 0; i < ({nv} + FS_LANES - 1) / FS_LANES; ++i) {{")
    self.emit("  const int k = l + i * FS_LANES;")
    self.emit(f"  if (k >= {nv}) break;")
    self.emit(f"  float acc = {terms[0][0]} * {terms[0][1]};")
    for w, d in terms[1:]:
      self.emit(f"  acc = fmaf({w}, {d}, acc);")
    self.emit(f"  {z.name}[k] = {z.name}[k] + acc;")
    self.emit("}")
    self.ops += self.mult * nv * 2 * len(rows)
    self._lanes_end()


class _CudaCells:
  """Mutable per-world values (z, lambda). `get` copies the current value
  into a temporary, so that a later `set` does not change what was read.
  Shared cells are written in lane regions only (`_CudaOps.axpy`)."""

  def __init__(self, k, name, shared=False):
    self.k, self.name, self.shared = k, name, shared

  def get(self, i):
    return self.k._def("float", f"{self.name}[{i}]", count=False)

  def set(self, i, v):
    if self.shared:
      raise AssertionError(f"serial code would write the shared {self.name}")
    self.k.emit(f"{self.name}[{i}] = {self.k.e(v)};")


class _CudaRows:
  """The rows of W = J M^-1 in the kernel: row r, dof j at jt[r * nv + j],
  in the world's shared memory."""

  def __init__(self, k, nv):
    self.k, self.nv = k, nv

  def elem(self, row, j):
    return _Val(self.k, f"jt[{row * self.nv + j}]")


# ---------------------------------------------------------------------------
# Phase emitters (K is the back end)
# ---------------------------------------------------------------------------


def _emit_fk_rnea(sd: _StaticData, K, q, u):
  """FK + RNEA bias. Returns (E0, r0, Rquat, Sw, h, EupL, rupL, Sbody): E0/r0
  per-body world->body transforms, Rquat the FREE/SPHERICAL bodies' raw
  quaternion rotations (for integration), Sw per-dof world subspace rows, h
  the (nv,) bias torque list."""
  nb, nv = sd.nb, sd.nv
  E0 = [None] * nb
  r0 = [None] * nb
  EupL = [None] * nb
  rupL = [None] * nb
  Rquat = {}
  Sbody = [None] * nb       # list of per-dof body-frame (w, v) rows
  Sw = [None] * nv
  vbody = [None] * nb
  vJs = [None] * nb
  cJs = [None] * nb

  for i in range(nb):
    jt = sd.joint_types[i]
    qa, va = sd.q_adr[i], sd.v_adr[i]
    XrT, Xr, Xp = sd.X_rotT[i], sd.X_rot[i], sd.X_pos[i]
    if jt == JointType.FREE:
      quat = (q[qa + 3], q[qa + 4], q[qa + 5], q[qa + 6])
      pos = (q[qa], q[qa + 1], q[qa + 2])
      R = _quat_to_mat(*quat)
      Rquat[i] = (quat, R)
      EJ = _mT(R)
      rJ = pos
      # S rows: ang k -> (e_k, 0); lin k -> (0, R[k, :])
      Srows = [((_I3[k]), (0.0, 0.0, 0.0)) for k in range(3)]
      Srows += [((0.0, 0.0, 0.0), tuple(R[k])) for k in range(3)]
      w_b = (u[va], u[va + 1], u[va + 2])
      v_b = _mTv(R, (u[va + 3], u[va + 4], u[va + 5]))
      vJ = (w_b, v_b)
      cJ = ((0.0, 0.0, 0.0), _vscale(-1.0, _cross(w_b, v_b)))
    elif jt == JointType.SPHERICAL:
      # ball joint: q = quat wxyz, u = omega in child body coords; constant
      # S = [I3 | 0], cJ = 0
      quat = (q[qa], q[qa + 1], q[qa + 2], q[qa + 3])
      R = _quat_to_mat(*quat)
      Rquat[i] = (quat, R)
      EJ = _mT(R)
      rJ = (0.0, 0.0, 0.0)
      Srows = [((_I3[k]), (0.0, 0.0, 0.0)) for k in range(3)]
      vJ = ((u[va], u[va + 1], u[va + 2]), (0.0, 0.0, 0.0))
      cJ = ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0))
    elif jt == JointType.REVOLUTE:
      th = q[qa]
      RJ = _rodrigues(sd.axis[i], K.cos(th), K.sin(th))
      EJ = _mT(RJ)
      rJ = (0.0, 0.0, 0.0)
      Srows = [(sd.axis[i], (0.0, 0.0, 0.0))]
      vJ = (_vscale(u[va], sd.axis[i]), (0.0, 0.0, 0.0))
      cJ = ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0))
    else:  # PRISMATIC
      d = q[qa]
      EJ = _I3
      rJ = _vscale(d, sd.axis[i])
      Srows = [((0.0, 0.0, 0.0), sd.axis[i])]
      vJ = ((0.0, 0.0, 0.0), _vscale(u[va], sd.axis[i]))
      cJ = ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0))
    # Xup = compose(X_J, X_tree): E = EJ @ Xr^T; r = Xp + Xr @ rJ
    Eup = _mm(EJ, XrT)
    rup = _vadd(Xp, _mv(Xr, rJ))
    EupL[i], rupL[i] = Eup, rup
    Sbody[i] = Srows
    vJs[i], cJs[i] = vJ, cJ
    p = sd.parent[i]
    if p < 0:
      E0[i], r0[i] = Eup, rup
      vbody[i] = vJ
    else:
      E0[i] = _mm(Eup, E0[p])
      r0[i] = _vadd(r0[p], _mTv(E0[p], rup))
      vbody[i] = _vadd6(_xf_motion(Eup, rup, vbody[p]), vJ)
    for k, srow in enumerate(Srows):
      Sw[va + k] = _xf_motion_inv(E0[i], r0[i], srow)

  # RNEA with qdd = 0: bias h
  g = sd.gravity
  a_base = ((0.0, 0.0, 0.0), (-g[0], -g[1], -g[2]))
  a = [None] * nb
  f = [None] * nb
  for i in range(nb):
    p = sd.parent[i]
    ap = a_base if p < 0 else a[p]
    a[i] = _vadd6(_xf_motion(EupL[i], rupL[i], ap), cJs[i],
                  _cross_motion(vbody[i], vJs[i]))
    Iv = _I_mul(sd.I6[i], vbody[i])
    f[i] = _vadd6(_I_mul(sd.I6[i], a[i]), _cross_force(vbody[i], Iv))

  h = [0.0] * nv
  for i in reversed(range(nb)):
    va = sd.v_adr[i]
    fn, fl = f[i]
    for k, (sw, sv) in enumerate(Sbody[i]):
      h[va + k] = _add2(_dot(sw, fn), _dot(sv, fl))
    p = sd.parent[i]
    if p >= 0:
      f[p] = _vadd6(f[p], _xf_force_inv(EupL[i], rupL[i], f[i]))

  return E0, r0, Rquat, Sw, h, EupL, rupL, Sbody


def _emit_crba(sd: _StaticData, EupL, rupL, Sbody, D_diag):
  """Composite-rigid-body mass matrix (+ implicit-PD dt*diag(D)) as a dense
  Python matrix of scalars (static zeros elided)."""
  nb, nv = sd.nb, sd.nv
  Ic = [sd.I6[i] for i in range(nb)]
  M = [[0.0] * nv for _ in range(nv)]

  def set_sym(i, j, val):
    M[i][j] = val
    if i != j:
      M[j][i] = val

  for i in reversed(range(nb)):
    p = sd.parent[i]
    if p >= 0:
      E, r = EupL[i], rupL[i]
      # Xm = [[E, 0], [-E r~, E]] (motion transform of Xup); congruence
      # Xm^T Ic Xm accumulates the child composite into the parent
      nEr = tuple(tuple(_neg(x) for x in row) for row in _mm(E, _skew(r)))
      Xm = (E, _Z3, nEr, E)
      Ic[p] = _b_add(Ic[p], _b_mm(_b_T(Xm), _b_mm(Ic[i], Xm)))
    va = sd.v_adr[i]
    nd = len(Sbody[i])
    # F_k = Ic_i @ S_k ; diag block M[va+k, va+l] = S_l . F_k
    Fs = [_I_mul(Ic[i], Sbody[i][k]) for k in range(nd)]
    for k in range(nd):
      for l in range(k, nd):
        sw, sv = Sbody[i][l]
        set_sym(va + k, va + l, _add2(_dot(sw, Fs[k][0]), _dot(sv, Fs[k][1])))
    # walk ancestors: F <- Xm^T F; off-diag blocks
    for k in range(nd):
      Fc = Fs[k]
      j = i
      while sd.parent[j] >= 0:
        Fc = _xf_force_inv(EupL[j], rupL[j], Fc)
        j = sd.parent[j]
        vb = sd.v_adr[j]
        for l, (sw, sv) in enumerate(Sbody[j]):
          set_sym(va + k, vb + l, _add2(_dot(sw, Fc[0]), _dot(sv, Fc[1])))

  for j in range(nv):
    if not (_is_c(D_diag[j]) and D_diag[j] == 0.0):
      M[j][j] = _add2(M[j][j], _mul(sd.dt, D_diag[j]))
  return M


def _emit_chol(K, nv: int, M):
  """Dense lower Cholesky over scalar entries; returns (L, invdiag)."""
  L = [[0.0] * nv for _ in range(nv)]
  invd = [None] * nv
  for k in range(nv):
    acc = M[k][k]
    for j in range(k):
      acc = _sub(acc, _mul(L[k][j], L[k][j]))
    dk = K.sqrt(acc)
    L[k][k] = dk
    invd[k] = 1.0 / dk
    for i in range(k + 1, nv):
      s = M[i][k]
      for j in range(k):
        s = _sub(s, _mul(L[i][j], L[k][j]))
      L[i][k] = _mul(invd[k], s)
  return L, invd


def _tri_solve(x, L, invd):
  """Phase F's substitutions, in place on the values x (one per dof):
  forward L y = x, then backward L^T x = y, multiplying by invd."""
  nv = len(x)
  for i in range(nv):
    acc = x[i]
    for j in range(i):
      if not (_is_c(L[i][j]) and L[i][j] == 0.0):
        acc = acc - x[j] * L[i][j]
    x[i] = acc * invd[i]
  for i in reversed(range(nv)):
    acc = x[i]
    for j in range(i + 1, nv):
      if not (_is_c(L[j][i]) and L[j][i] == 0.0):
        acc = acc - x[j] * L[j][i]
    x[i] = acc * invd[i]


def _emit_hm_probe(hm: _HmStatic, K, ca, r: float):
  """heightmap._point_contact of the point ca (a sphere of static radius r;
  r = 0 for a point) against this world's field. Returns (pos, normal,
  depth, valid), valid a float 0/1.

  The same sample order, gates and first-match best-candidate selection as
  the full-field march; the heights of a sample's cell are loaded directly.
  An x-march sample keeps the centre's j and v (its y is the centre's, so
  they agree bitwise), a y-march sample its i and u. Every `jnp.where` is a
  select over both branches, and in-bounds masks stay floats, as in the TPU
  kernel."""
  px, py, pz = ca

  def axis(x, c, half, d, n):
    """surface_at along one axis: (cell index, fraction, 0 <= f <= n - 1)."""
    f = _add2(_sub(x, c), half) / d
    i = K.minimum(K.maximum(K.floor(f), 0.0), n - 2.0)
    w = K.minimum(K.maximum(f - i, 0.0), 1.0)
    return i, w, (f >= 0.0) & (f <= n - 1.0)

  def tri(i, j, uu, vv):
    """surface_at's triangle plane of cell (i, j): height and unit normal."""
    cell = K.cell_index(i, j)
    h00, h10 = K.height(cell, 0, 0), K.height(cell, 1, 0)
    h01, h11 = K.height(cell, 0, 1), K.height(cell, 1, 1)
    lower = (uu + vv) <= 1.0
    z_low = h00 + uu * (h10 - h00) + vv * (h01 - h00)
    z_up = h11 + (1.0 - uu) * (h01 - h11) + (1.0 - vv) * (h10 - h11)
    z = K.where(lower, z_low, z_up)
    gx = K.where(lower, h10 - h00, h11 - h01) / hm.dx
    gy = K.where(lower, h01 - h00, h11 - h10) / hm.dy
    norm = K.sqrt(gx * gx + gy * gy + 1.0 + 1e-18)
    return z, (-gx / norm, -gy / norm, 1.0 / norm)

  i, u, in_x = axis(px, hm.cx, hm.hx, hm.dx, hm.nx)
  j, v, in_y = axis(py, hm.cy, hm.hy, hm.dy, hm.ny)
  z_c, n_c = tri(i, j, u, v)
  depth = _sub(r, n_c[2] * (pz - z_c))
  if r == 0.0:
    return (px, py, pz), n_c, depth, K.to_float((depth > 0.0) & in_x & in_y)

  best_d, best_n, best_in = depth, n_c, K.to_float(in_x & in_y)
  for oxd, oyd in ((1.0, 0.0), (-1.0, 0.0), (0.0, 1.0), (0.0, -1.0)):
    ndir = (-oxd, -oyd, 0.0)                       # wall normal: towards the centre
    for f in (0.25, 0.5, 0.75, 1.0):
      if oyd == 0.0:
        qx, qy = px + oxd * (f * r), py
        i_s, u_s, in_s = axis(qx, hm.cx, hm.hx, hm.dx, hm.nx)
        z_k, n_k = tri(i_s, j, u_s, v)
        in_k = K.to_float(in_s & in_y)
      else:
        qx, qy = px, py + oyd * (f * r)
        j_s, v_s, in_s = axis(qy, hm.cy, hm.hy, hm.dy, hm.ny)
        z_k, n_k = tri(i, j_s, u, v_s)
        in_k = K.to_float(in_x & in_s)
      d_k = _dot(n_k, _vsub((px, py, pz), (qx, qy, z_k)))
      dep_plane = K.where(n_k[2] < 0.77, r - d_k, -1.0)
      dep_wall = K.where(z_k > pz, r - f * r, -1.0)
      use_plane = dep_plane >= dep_wall
      dep_k = K.maximum(dep_plane, dep_wall)
      n_cand = tuple(K.where(use_plane, n_k[a], ndir[a]) for a in range(3))
      better = dep_k > best_d
      best_d = K.where(better, dep_k, best_d)
      best_n = tuple(K.where(better, n_cand[a], best_n[a]) for a in range(3))
      best_in = K.where(better, in_k, best_in)
  pos = _vsub((px, py, pz), _vscale(r, best_n))
  return pos, best_n, best_d, K.to_float(best_d > 0.0) * best_in


def _runtime_frame(K, n):
  """(t1, t2) for a runtime unit normal n: pipeline._tangent_frames'
  least-aligned-axis pick (ties go to x, then y), with rsqrt."""
  ax = tuple(K.abs(c) for c in n)
  pick_x = (ax[0] <= ax[1]) & (ax[0] <= ax[2])
  pick_y = ~pick_x & (ax[1] <= ax[2])
  fx, fy = K.to_float(pick_x), K.to_float(pick_y)
  t1 = _cross(n, (fx, fy, 1.0 - fx - fy))
  inv = K.rsqrt(_add(*[_mul(c, c) for c in t1]) + 1e-18)
  t1 = _vscale(inv, t1)
  return t1, _cross(n, t1)


def _emit_downhill_frame(K, Rg):
  """collision.downhill_frame of one geom rotation Rg: (a, u, w), the axis,
  the downhill rim direction (Rg's x column when the axis is vertical) and
  a x u."""
  a = tuple(Rg[k][2] for k in range(3))
  radial = (_neg(_mul(a[2], a[0])), _neg(_mul(a[2], a[1])), _sub(1.0, _mul(a[2], a[2])))
  rn = K.sqrt(_add(*[_mul(c, c) for c in radial]))
  degen = rn < 1e-6
  denom = K.where(degen, 1.0, rn)
  u0 = tuple(K.where(degen, Rg[k][0], _neg(radial[k]) / denom) for k in range(3))
  un = K.sqrt(_add(*[_mul(c, c) for c in u0]) + 1e-18)
  u = tuple(c / un for c in u0)
  return a, u, _cross(a, u)


def _emit_shape_point(slot: _Slot, frame):
  """The world point of an "hm_cylpt" or "hm_conept" slot: collision's
  cylinder_points / cone_points in the geom's frame (pg, a, u, w)."""
  pg, a, u, w = frame
  r, hl = slot.he[0], slot.he[1]
  if slot.kind == "hm_cylpt":
    center = _vadd(pg, _vscale(slot.local[0] * hl, a))
  elif slot.local[0] == 0.0:                       # the cone's apex
    return _vadd(pg, _vscale(0.75 * hl, a))
  else:                                            # a point of the cone's base rim
    center = _vadd(pg, _vscale(-0.25 * hl, a))
  phi = slot.local[1]
  rim = _vadd(_vscale(float(np.cos(phi)), u), _vscale(float(np.sin(phi)), w))
  return _vadd(center, _vscale(r, rim))


def _emit_deepest4(K, probes):
  """collision.deepest4 over probes (pos, normal, depth, valid): four passes
  of a max sweep, each taking the first probe at the maximum (so equal
  depths go in probe order) and setting its depth to -3e38 for the later
  passes. Returns the 4 selected probes, deepest first."""
  dcur = [p[2] for p in probes]
  sel = []
  for _ in range(4):
    dmax = dcur[0]
    for d in dcur[1:]:
      dmax = K.maximum(dmax, d)
    taken = 0.0
    pk, nk, dk, ak = _ZV, _ZV, 0.0, 0.0
    for i, (pos, nrm, _, valid) in enumerate(probes):
      c = _mul(K.to_float(K.bin("==", dcur[i], dmax)), _sub(1.0, taken))
      taken = _add2(taken, c)
      pk = _vadd(pk, _vscale(c, pos))
      nk = _vadd(nk, _vscale(c, nrm))
      dk = _add2(dk, _mul(c, dcur[i]))
      ak = _add2(ak, _mul(c, valid))
      dcur[i] = K.where(c > 0.5, -3e38, dcur[i])
    sel.append((pk, nk, dk, ak))
  return sel


def _emit_sphere_pair(K, slot: _Slot, ca, Rbw, pbw):
  """The sphere of centre ca and radius slot.radius against geom B of an
  "ss", "sb" or "sc" slot, whose body has the pose (Rbw, pbw). Returns (pos,
  normal (B -> A), depth): the JAX emitter's scalar port of
  collision._sphere_sphere, _sphere_box and _sphere_capsule."""
  clip = lambda x, lo, hi: K.minimum(K.maximum(x, lo), hi)   # noqa: E731
  Rb = _mm(Rbw, slot.b_rot)                      # geom B's pose, world
  pb = _vadd(pbw, _mv(Rbw, slot.b_pos))
  if slot.kind != "sb":
    if slot.kind == "sc":                        # clamp onto the segment
      axis = tuple(Rb[k][2] for k in range(3))
      hl = slot.he[1]
      t_ = clip(_dot(_vsub(ca, pb), axis), -hl, hl)
      cb = _vadd(pb, _vscale(t_, axis))
    else:                                        # "ss": b_rot is the identity
      cb = pb
    d = _vsub(ca, cb)
    dist = K.sqrt(_add(*[_mul(c, c) for c in d]) + 1e-18)
    nrm = _vscale(1.0 / dist, d)
    depth = _sub(slot.radius + slot.rb, dist)
    return _vadd(cb, _vscale(_sub(slot.rb, 0.5 * depth), nrm)), nrm, depth
  # "sb": the closest point of the box outside it; inside, the face of least
  # penetration (first match on ties) with a sign that is never 0
  cl = _mTv(Rb, _vsub(ca, pb))                   # sphere centre, box frame
  he = slot.he
  clamped = tuple(clip(cl[k], -he[k], he[k]) for k in range(3))
  delta = _vsub(cl, clamped)
  dist = K.sqrt(_add(*[_mul(c, c) for c in delta]) + 1e-18)
  outside = dist > 1e-9
  n_out = _vscale(1.0 / dist, delta)
  fp = tuple(_sub(he[k], K.abs(cl[k])) for k in range(3))
  is0 = (fp[0] <= fp[1]) & (fp[0] <= fp[2])
  is1 = ~is0 & (fp[1] <= fp[2])
  ind0, ind1 = K.to_float(is0), K.to_float(is1)
  ind = (ind0, ind1, 1.0 - ind0 - ind1)
  fp_k = _add(*[_mul(ind[k], fp[k]) for k in range(3)])
  sgn = tuple(K.where(cl[k] >= 0.0, 1.0, -1.0) for k in range(3))
  n_in = tuple(_mul(sgn[k], ind[k]) for k in range(3))
  n_local = tuple(K.where(outside, n_out[k], n_in[k]) for k in range(3))
  depth = K.where(outside, _sub(slot.radius, dist), _add2(slot.radius, fp_k))
  surf = tuple(K.where(outside, clamped[k], _add2(cl[k], _mul(n_in[k], fp_k)))
               for k in range(3))
  return _vadd(pb, _mv(Rb, surf)), _mv(Rb, n_local), depth


def _emit_step(sd: _StaticData, K, q, u, tau_in, pd_in):
  """Phases A-I for one world, on the values q (nq), u, tau_in, pd_in (nv;
  pd_in None without PD). Returns the lists (q', u')."""
  nv, nb = sd.nv, sd.nb
  dt = sd.dt

  # ---- A. actuation: feedforward + implicit PD, clamp ----
  tau = [0.0] * nv
  D_diag = [0.0] * nv
  for j in range(nv):
    t = _mul(sd.actuated[j], tau_in[j])
    if sd.use_pd:
      if sd.actuated[j] != 0.0 and sd.jmask[j] != 0.0:
        t = _add2(t, _mul(sd.kp[j] * sd.actuated[j],
                          _sub(pd_in[j], q[sd.jidx[j]])))
      D_diag[j] = sd.kd[j] * sd.actuated[j]
    tl = sd.torque_limit[j]
    if not _is_c(t):
      t = K.minimum(K.maximum(t, -tl), tl)
    tau[j] = t

  # ---- B/C. FK + RNEA ----
  E0, r0, Rquat, Sw, h, EupL, rupL, Sbody = _emit_fk_rnea(sd, K, q, u)

  # ---- D. CRBA + Cholesky ----
  M = _emit_crba(sd, EupL, rupL, Sbody, D_diag)
  L, invd = _emit_chol(K, nv, M)

  # ---- E. contact rows and limit rows. Plane: the static frame t1=+y,
  #      t2=-x, n=+z (pipeline._tangent_frames for n = z); heightmap and
  #      sphere pairs: the runtime normal and its runtime frame ----
  ncone = len(sd.slots)
  nlim = len(sd.limits)
  Jrows = [dict() for _ in range(3 * ncone + nlim)]   # row -> {dof: scalar}
  bias = [0.0] * (3 * ncone + nlim)
  act = [None] * (ncone + nlim)

  def body_pose(b):
    """(R body -> world, p) of body b; the identity for b = -1 (the world)."""
    if b < 0:
      return _I3, (0.0, 0.0, 0.0)
    return _mT(E0[b]), r0[b]

  frames = {}        # (body, b_pos, b_rot, he) -> a cylinder's or cone's frame
  mesh_sel = {}      # mesh index -> its 4 selected probes
  for s_i, slot in enumerate(sd.slots):
    ba = slot.body_a
    Ra, pa_ = body_pose(ba)
    if slot.kind in ("hm_cylpt", "hm_conept"):
      key = (ba, slot.b_pos, slot.b_rot, slot.he)
      if key not in frames:                      # one frame for the geom's slots
        frames[key] = (_vadd(pa_, _mv(Ra, slot.b_pos)),
                       *_emit_downhill_frame(K, _mm(Ra, slot.b_rot)))
      pos, nrm, depth, act[s_i] = _emit_hm_probe(
          sd.hm, K, _emit_shape_point(slot, frames[key]), 0.0)
      t1, t2 = _runtime_frame(K, nrm)
    elif slot.kind == "hm_mesh":
      mi, k_out = int(slot.local[0]), int(slot.local[1])
      if mi not in mesh_sel:                     # one selection for the mesh's 4 slots
        body, verts, _ = sd.hm_meshes[mi]
        Rm, pm = body_pose(body)
        mesh_sel[mi] = _emit_deepest4(K, [_emit_hm_probe(sd.hm, K, _vadd(pm, _mv(Rm, v)), 0.0)
                                          for v in verts])
      pos, nrm, depth, act[s_i] = mesh_sel[mi][k_out]
      t1, t2 = _runtime_frame(K, nrm)
    else:
      ca = _vadd(pa_, _mv(Ra, slot.local))       # feature point / centre, world
      if slot.kind == "plane_pt":
        depth = _sub(slot.plane_h + slot.radius, ca[2])
        pos = (ca[0], ca[1], _sub(ca[2], slot.radius))
        t1, t2, nrm = (0.0, 1.0, 0.0), (-1.0, 0.0, 0.0), (0.0, 0.0, 1.0)
        act[s_i] = K.to_float(depth > 0.0)
      elif slot.kind == "hm_pt":
        pos, nrm, depth, act[s_i] = _emit_hm_probe(sd.hm, K, ca, slot.radius)
        t1, t2 = _runtime_frame(K, nrm)
      else:                                      # "ss", "sb", "sc"
        pos, nrm, depth = _emit_sphere_pair(K, slot, ca, *body_pose(slot.body_b))
        t1, t2 = _runtime_frame(K, nrm)
        act[s_i] = K.to_float(depth > 0.0)
    # the relative-velocity Jacobian v(A) - v(B): +1 on A's ancestor dofs,
    # -1 on B's, and a dof both move drops out
    cmap = {j: 1.0 for j in sd.anc_dofs[ba]} if ba >= 0 else {}
    if slot.body_b >= 0:
      for j in sd.anc_dofs[slot.body_b]:
        cmap[j] = cmap.get(j, 0.0) - 1.0
    r_t1, r_t2, r_n = 3 * s_i, 3 * s_i + 1, 3 * s_i + 2
    vn_pre = 0.0
    for j, cj in cmap.items():
      if cj == 0.0:
        continue
      ang, lin = Sw[j]
      col = _vscale(cj, _vadd(lin, _cross(ang, pos)))
      Jrows[r_t1][j] = _dot(col, t1)
      Jrows[r_t2][j] = _dot(col, t2)
      Jrows[r_n][j] = _dot(col, nrm)
      vn_pre = _add2(vn_pre, _mul(_dot(col, nrm), u[j]))
    b_baum = K.minimum(
        sd.erp * K.maximum(depth - sd.slop, 0.0) / dt, sd.max_corr)
    if slot.e > 0.0:
      b_rest = K.where(vn_pre < -slot.thresh, -slot.e * vn_pre, 0.0)
      bias[r_n] = K.maximum(b_rest, b_baum)
    else:
      bias[r_n] = b_baum

  for k, lim in enumerate(sd.limits):
    row = 3 * ncone + k
    q_pred = _add2(q[lim.qadr], _mul(dt, u[lim.vadr]))
    near_hi = q_pred > lim.hi
    near_lo = q_pred < lim.lo
    s = K.where(near_hi, -1.0, 1.0)
    viol = K.maximum(lim.lo - q_pred, q_pred - lim.hi)
    bias[row] = K.minimum(K.maximum(sd.erp * K.maximum(viol, 0.0) / dt, 0.0),
                          sd.max_corr)
    act[ncone + k] = K.to_float(near_lo | near_hi)
    Jrows[row][lim.vadr] = s

  # ---- F. triangular solves: columns = W rows (J M^-1) + the v_free rhs ----
  rhs0 = [_sub(_sub(tau[j], h[j]), _mul(D_diag[j], u[j])) for j in range(nv)]
  W, vf_col = K.solve_columns(Jrows, rhs0, L, invd)
  vf = [_add2(u[j], _mul(dt, vf_col[j])) for j in range(nv)]

  # ---- G. hoisted GS invariants ----
  Gii_all, g_packed, ci0_all = [], [], []
  for i in range(ncone):
    g = {}
    for a in range(3):
      for bb in range(a, 3):
        tot = 0.0
        for j, val in Jrows[3 * i + a].items():
          tot = _add2(tot, _mul(val, W.elem(3 * i + bb, j)))
        g[(a, bb)] = tot
    gi = (g[(0, 0)], g[(0, 1)], g[(0, 2)], g[(1, 1)], g[(1, 2)], g[(2, 2)])
    Gii_all.append(gi)
    g_packed.append(K.pack(f"gii{i}", gi))
    ci0 = []
    for a in range(3):
      tot = _neg(bias[3 * i + a])
      for j, val in Jrows[3 * i + a].items():
        tot = _add2(tot, _mul(val, vf[j]))
      ci0.append(tot)
    ci0_all.append(tuple(ci0))
  lim_g, lim_ci0 = [], []
  for k in range(nlim):
    row = 3 * ncone + k
    j = sd.limits[k].vadr
    sval = Jrows[row][j]
    # G_rr = J_row . W_row = s * (s * Minv_jj) = Minv_jj (W already carries s)
    lim_g.append(_mul(sval, W.elem(row, j)))
    lim_ci0.append(_sub(_mul(sval, vf[j]), bias[row]))

  # ---- H. matrix-free Gauss-Seidel cone solve, then the limit rows ----
  z = K.cells("z", nv)
  lam = K.cells("lam", 3 * ncone + nlim)

  def sweep_body():
    for i in range(ncone):
      g = Gii_all[i]
      li = [lam.get(3 * i + a) for a in range(3)]
      g_mat = ((g[0], g[1], g[2]), (g[1], g[3], g[4]), (g[2], g[4], g[5]))
      ci = []
      for a in range(3):
        diag_a = g_mat[a][0] * li[0] + g_mat[a][1] * li[1] + g_mat[a][2] * li[2]
        jz = 0.0
        for j, val in Jrows[3 * i + a].items():
          jz = _add2(jz, _mul(val, z.get(j)))
        ci.append(ci0_all[i][a] + jz - diag_a)
      ln = K.cone_solve(g_packed[i], ci, sd.slots[i].mu, sd.n_grid)
      ds = []
      for a in range(3):
        la = ln[a] * act[i]
        ds.append(la - li[a])
        lam.set(3 * i + a, la)
      K.axpy(z, W, [3 * i, 3 * i + 1, 3 * i + 2], ds)
    for k in range(nlim):
      row = 3 * ncone + k
      jdof = sd.limits[k].vadr
      li2 = lam.get(row)
      jz = _mul(Jrows[row][jdof], z.get(jdof))
      c2 = lim_ci0[k] + jz - lim_g[k] * li2
      ln2 = K.maximum(-c2 / (lim_g[k] + 1e-20), 0.0) * act[ncone + k]
      K.axpy(z, W, [row], [ln2 - li2])
      lam.set(row, ln2)

  if ncone + nlim:
    K.repeat(sd.sweeps, sweep_body)

  # ---- I. integrate (quaternion exp-map for FREE and SPHERICAL) ----
  u_new = [_add2(vf[j], z.get(j)) for j in range(nv)]
  q_new = [None] * sd.nq

  def quat_step(quat, R, va):
    w_w = _mv(R, (u_new[va], u_new[va + 1], u_new[va + 2]))
    wdt = _vscale(dt, w_w)
    ang2 = _add(*[_mul(x, x) for x in wdt])
    angle = K.sqrt(ang2 + 1e-32)
    half = 0.5 * angle
    sinc_half = K.where(ang2 > 1e-16, K.sin(half) / angle, 0.5 - ang2 / 48.0)
    dq = (K.cos(half), sinc_half * wdt[0], sinc_half * wdt[1],
          sinc_half * wdt[2])
    w1, x1, y1, z1 = dq
    w2, x2, y2, z2 = quat
    qn = (w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
          w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
          w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
          w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2)
    norm = K.rsqrt(qn[0] * qn[0] + qn[1] * qn[1] + qn[2] * qn[2]
                   + qn[3] * qn[3] + 1e-12)
    return [qn[k] * norm for k in range(4)]

  for i in range(nb):
    jt = sd.joint_types[i]
    qa, va = sd.q_adr[i], sd.v_adr[i]
    if jt == JointType.FREE:
      quat, R = Rquat[i]
      for k in range(3):
        q_new[qa + k] = _add2(q[qa + k], _mul(dt, u_new[va + 3 + k]))
      q_new[qa + 3:qa + 7] = quat_step(quat, R, va)
    elif jt == JointType.SPHERICAL:
      quat, R = Rquat[i]
      q_new[qa:qa + 4] = quat_step(quat, R, va)
    else:
      q_new[qa] = _add2(q[qa], _mul(dt, u_new[va]))
  return q_new, u_new


# ---------------------------------------------------------------------------
# The plain twin and the kernel source
# ---------------------------------------------------------------------------


def _fused_plain(sd: _StaticData, q, u, tau, pd=None, heights=None,
                 return_ops: bool = False):
  """The kernel's arithmetic in plain PyTorch: q (B, nq), u, tau, pd (B, nv)
  and, on a heightmap scene, heights (B, nx, ny) on any device, in their
  dtype. Returns (q', u') (and the per-world operation tally if
  `return_ops`)."""
  if (heights is None) != (sd.hm is None):
    raise ValueError("heights are needed exactly for a heightmap scene")
  K = _TorchOps(q.shape[0], q.dtype, q.device, heights)
  cols = lambda x, n: [_Val(K, x[:, k]) for k in range(n)]   # noqa: E731
  pd_v = cols(pd, sd.nv) if sd.use_pd else None
  q_new, u_new = _emit_step(sd, K, cols(q, sd.nq), cols(u, sd.nv),
                            cols(tau, sd.nv), pd_v)
  out = (torch.stack([K.t(x) for x in q_new], 1),
         torch.stack([K.t(x) for x in u_new], 1))
  return out + (K.ops,) if return_ops else out


_SOURCE_HEAD = """\
// Fused full physics step (K1) for one scene, FS_LANES lanes per world.
// Generated by raisimlib_torch/ops/gpu_step.py (kernel_source) from the
// scene's static data; the frame (lanes -> world, launch) is
// csrc/fused_step.cuh. {summary}
#include <cuda_runtime.h>
#include <math.h>

#define FS_NQ {nq}
#define FS_NV {nv}
#define FS_USE_PD {use_pd}
#define FS_HAS_HM {has_hm}
#define FS_SMEM_WORLD {smem_world}
#ifndef FS_MIN_BLOCKS
#define FS_MIN_BLOCKS {min_blocks}
#endif
#ifndef FS_LANES
#define FS_LANES {lanes}
#endif
// A lane region: lane l = fs_lane of the world runs the body for its own l.
// The syncs, over the whole warp (a block is one warp, and all its worlds
// pass the same regions in the same order), order the region's shared-memory
// writes after every lane's earlier reads and before its later ones. The
// cone solve's exchanges between lanes (cone_solve.cuh) take the whole warp
// too.
#ifndef FS_LANES_BEGIN
#define FS_LANES_BEGIN __syncwarp(); {{ const int l = fs_lane;
#define FS_LANES_END }} __syncwarp();
#define FS_LANE_MASK 0xffffffffu
#endif
{solve}
#include "cone_solve.cuh"

// the body loads every input and names every intermediate; nvcc drops the
// ones a scene does not use
#pragma nv_diag_suppress 177

namespace {{

// One world's step, run alike by each of its lanes; fs_smem is the world's
// slice of shared memory (FS_SMEM_WORLD floats), qo and uo are null in the
// lanes that do not store. fs_smem is not __restrict__: the other lanes
// write through it too, and a restricted pointer would let the compiler move
// its loads and stores across the lane regions' syncs.
__device__ __forceinline__ void fs_body(const float* __restrict__ q,
                                        const float* __restrict__ u,
                                        const float* __restrict__ tau,
                                        const float* __restrict__ pd,
                                        const float* __restrict__ hts,
                                        float* __restrict__ qo,
                                        float* __restrict__ uo,
                                        float* fs_smem, const int fs_lane) {{
"""

_SOURCE_TAIL = """\
}

}  // namespace

#include "fused_step.cuh"
"""


def _smem_layout(sd: _StaticData) -> dict:
  """Offsets (floats) of one world's shared arrays, in order: jt, the W rows
  and the v_free column ((nw + 1) x nv, nw = 3 ncone + nlim); jr, the
  distinct runtime values of J (at most its nonzeros: each contact row moves
  the dofs of its bodies' ancestors, each limit row one dof; `jr_size`);
  gii, the cones' hoisted 3x3 blocks (6 ncone); z (nv); trig, the sines
  and cosines of the cone solve's grid (2 n_grid); and their total."""
  nv, nw = sd.nv, 3 * len(sd.slots) + len(sd.limits)
  jr = len(sd.limits) + sum(
      3 * len(set(sd.anc_dofs[s.body_a] if s.body_a >= 0 else ())
              | set(sd.anc_dofs[s.body_b] if s.body_b >= 0 else ())) for s in sd.slots)
  sizes = (("jt", (nw + 1) * nv), ("jr", jr), ("gii", 6 * len(sd.slots)), ("z", nv),
           ("trig", 2 * sd.n_grid))
  out, off = {"jr_size": jr}, 0
  for name, n in sizes:
    out[name], off = off, off + n
  out["total"] = off
  return out


def smem_bytes(sd: _StaticData, lanes: int = LANES) -> int:
  """Bytes of shared memory one 32-thread block of the kernel holds, the
  arrays of its 32 // lanes worlds. Raises FusedStepUnsupported above the
  227 KB an H100 gives one block."""
  n = 4 * (BLOCK // lanes) * _smem_layout(sd)["total"]
  if n > SMEM_BLOCK_LIMIT:
    raise FusedStepUnsupported(
        f"the fused step's block would hold {n} bytes of shared memory ({BLOCK // lanes} "
        f"worlds of nv = {sd.nv} with {len(sd.slots)} contact slots and {len(sd.limits)} "
        f"limit rows), over the {SMEM_BLOCK_LIMIT} a block can hold")
  return n


def min_blocks(sd: _StaticData, lanes: int = LANES) -> int:
  """__launch_bounds__' minimum of blocks per SM for the scene's kernel
  (FS_MIN_BLOCKS): 16, which caps a thread at 128 registers, where an SM can
  hold 16 blocks' shared arrays; else 1 (up to 255 registers). A warp's
  lanes wait on one world's serial chain, so a large batch goes as fast as
  the warps an SM holds: where 16 blocks fit (the sphere-box stack), the cap
  doubles them for a few hundred bytes of spills; where shared memory stops
  at 10 blocks (ANYmal), it would gain 2 warps for several KB of spills. The
  wide build (one world a block) runs only where the batch fits the card in
  one wave (`lanes_for`), where latency counts and occupancy does not: it
  keeps up to 255 registers (capped at 128 it ran 2-21% slower at B <= 1024
  on an H100: ANYmal on flat ground and on terrain, the sphere-box stack)."""
  if lanes == WIDE:
    return 1
  return 16 if 16 * (smem_bytes(sd, lanes) + 1024) <= SM_SMEM else 1


# The sweeps call one out-of-line copy of the cone solve from each contact
# slot where the build at `lanes` holds at least CALL_MIN_SLOTS[lanes] slots
# and, at WIDE lanes, nv is at most CALL_WIDE_MAX_NV (`solve_called`).
CALL_MIN_SLOTS = {LANES: 8, WIDE: 12}
CALL_WIDE_MAX_NV = 18
_SOLVE_HEAD = {
    True: "// The cone solve out of line (gpu_step.solve_called): each contact slot of a\n"
          "// sweep calls the one copy of rsl::cone_solve_lanes.\n"
          "#define RSL_CONE_SOLVE_ATTR __noinline__\n",
    False: "// The cone solve inlined into each contact slot (gpu_step.solve_called).\n"}


def solve_called(sd: _StaticData, lanes: int = LANES) -> bool:
  """Whether the scene's build at `lanes` lanes per world calls one
  out-of-line copy of the cone solve from each contact slot of a sweep
  (RSL_CONE_SOLVE_ATTR __noinline__), rather than inline a copy into each
  slot (cone_solve.cuh's default). Copies inlined slot by slot make the
  sweeps' loop larger than an SM's instruction cache once there are enough
  of them, and sooner at 8 lanes, where a copy unrolls 4 grid points a
  lane, than at 32 (one); a call saves and restores the live registers
  around each solve. Each build alone on an H100 (tools/lanes_sweep.py
  --solve called inlined), the called build's time over the inlined one's:
  at 8 lanes ANYmal (12 slots, nv = 18) 0.69-0.75 at B = 1-16384 (the iLQR
  scene 0.72 at 39,200), the sphere-box stack (10) 0.74-0.90 at
  384-16384, Atlas (32, nv = 29) 0.87-0.88 at 1024 and 16384, but the
  cylinder (6 slots) 1.046, the cone (4) 1.065 and the rock (4) 0.996 at
  16384; at 32 lanes ANYmal 0.68-0.79 at B = 1-16384, but the stack
  1.017-1.051 at 384 and 1024, and Atlas 1.145 at 1024 and 1.260 at 16384
  (its spill stores 10,248 -> 11,616 B a thread; the cause is not
  separated from nv)."""
  if len(sd.slots) < CALL_MIN_SLOTS[WIDE if lanes == WIDE else LANES]:
    return False
  return lanes != WIDE or sd.nv <= CALL_WIDE_MAX_NV


def lanes_for(B: int, sms: int, blocks_per_sm: int, probes: bool = False) -> int:
  """Lanes per world for a launch of B worlds on a card of `sms` SMs, where
  the wide build (WIDE lanes, one world a block) holds `blocks_per_sm`
  blocks an SM: WIDE where the B worlds, a warp each, fit the card in one
  wave, else LANES. In one wave every world starts at once and the time is
  one world's chain, which more lanes cut; past it a world waits for a
  slot, and the narrow build's 4 worlds a warp do more work an SM. Where a
  world `probes` a heightmap (its source loads heights), the wave holds at
  most one warp per scheduler (SM_SCHEDULERS an SM): each world's chain of
  dependent height loads then runs on a whole warp, and past that the
  narrow build was the faster on an H100 (ANYmal on terrain: 8 lanes
  faster by 1.5% and 6% at B = 768 and 1024, 32 lanes by 21% at 384; flat
  ANYmal: 32 lanes faster up to 1024)."""
  per_sm = min(blocks_per_sm, SM_SCHEDULERS) if probes else blocks_per_sm
  return WIDE if B <= sms * per_sm else LANES


def _source_body(sd: _StaticData):
  """The body of the fused step's source for `sd` (everything but the head's
  lane count and register cap), its operation tally per world and its height
  loads per world."""
  layout = _smem_layout(sd)
  K = _CudaOps(sd.hm.ny if sd.hm is not None else 0, layout)
  dth = 2.0 * math.pi / sd.n_grid
  K.emit(f"const rsl::ConeConsts cc = {{{sd.n_grid}, {_lit(dth)}, {_lit(0.5 * dth)}, "
         f"{_lit(0.125 * dth)}, {_lit(dth / 16.0)}}};")
  if sd.slots:
    K.emit(f"rsl::cone_grid_trig(cc, fs_smem + {layout['trig']}, fs_lane);")

  def loads(name, n):
    vals = []
    for k in range(n):
      K.emit(f"const float {name}{k} = {name}[{k}];")
      vals.append(_Val(K, f"{name}{k}"))
    return vals

  q, u, tau = loads("q", sd.nq), loads("u", sd.nv), loads("tau", sd.nv)
  pd = loads("pd", sd.nv) if sd.use_pd else None
  q_new, u_new = _emit_step(sd, K, q, u, tau, pd)
  K.emit("if (qo != nullptr) {")
  for k, x in enumerate(q_new):
    K.emit(f"  qo[{k}] = {K.e(x)};")
  for k, x in enumerate(u_new):
    K.emit(f"  uo[{k}] = {K.e(x)};")
  K.emit("}")
  kinds = sorted({s.kind for s in sd.slots})
  summary = (f"nb = {sd.nb}, nq = {sd.nq}, nv = {sd.nv}, {len(sd.slots)} contact "
             f"slots ({', '.join(kinds) or 'none'}), {len(sd.limits)} limit rows, "
             f"{sd.sweeps} sweeps: {K.ops} operations and {K.loads} height loads "
             f"per world, {4 * layout['total']} bytes of shared memory.")
  head = dict(summary=summary, nq=sd.nq, nv=sd.nv, use_pd=int(sd.use_pd),
              has_hm=int(sd.hm is not None), smem_world=layout["total"])
  return head, "\n".join(_fuse_products(K.lines)) + "\n" + _SOURCE_TAIL, K.ops, K.loads


_DEF = re.compile(r"(?:const )?(?:float|bool|int) \w+ = [^;]*;")
_SUM = re.compile(r"float (t\d+) = (\S+) ([*+-]) (\S+);")


def _fuse_products(lines):
  """The body's lines with each product that one sum or difference reads,
  and nothing else, fused into it: `float tp = a * b;` ... `float ts = tp + c;`
  becomes `float ts = fmaf(a, b, c);` (a - b: fmaf(-(a), b, c) or fmaf(a, b,
  -(c))), where only definitions of other values lie between the two
  lines, so that a and b still hold their values there. Of two products,
  the second is fused. The kernel compiles with --fmad=false (`_FLAGS`),
  so these are the FMAs of the generated code:
  each value rounds as its line says, whatever code the lane count puts
  around it, and every build of a scene gives the same bits."""
  uses = collections.Counter(re.findall(r"\bt\d+\b", "\n".join(lines)))
  prod, out = {}, list(lines)              # fusable product -> (its line, a, b)
  for i, ln in enumerate(lines):
    text = ln.strip()
    m = _SUM.fullmatch(text)
    if m is None:
      if _DEF.fullmatch(text) is None:
        prod.clear()                         # a store, a call, a brace: no fusing across it
      continue
    t, x, op, y = m.groups()
    if op == "*":
      if uses[t] == 2:                       # its definition and one read
        prod[t] = (i, x, y)
      continue
    pad = ln[:len(ln) - len(ln.lstrip())]
    if y in prod:
      j, a, b = prod.pop(y)
      out[i] = f"{pad}float {t} = fmaf({'-(' + a + ')' if op == '-' else a}, {b}, {x});"
    elif x in prod:
      j, a, b = prod.pop(x)
      out[i] = f"{pad}float {t} = fmaf({a}, {b}, {'-(' + y + ')' if op == '-' else y});"
    else:
      continue
    out[j] = None
  return [ln for ln in out if ln is not None]


def _with_head(sd: _StaticData, head: dict, body: str, lanes: int) -> str:
  return _SOURCE_HEAD.format(lanes=lanes, min_blocks=min_blocks(sd, lanes),
                             solve=_SOLVE_HEAD[solve_called(sd, lanes)], **head) + body


def kernel_source(sd: _StaticData, lanes: int = LANES):
  """The CUDA source of the fused step for `sd` at `lanes` lanes per world,
  its operation tally per world and its height loads per world.
  Deterministic: the same static data gives the same text. Raises
  FusedStepUnsupported where a block cannot hold its worlds' shared arrays
  (`smem_bytes`)."""
  smem_bytes(sd, lanes)
  head, body, ops, loads = _source_body(sd)
  return _with_head(sd, head, body, lanes), ops, loads


# ---------------------------------------------------------------------------
# The kernel and the public wrapper
# ---------------------------------------------------------------------------

_SYMBOLS = {"fused_step_launch": [ctypes.c_void_p] * 5 + [ctypes.c_longlong]
             + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p],
            "fused_step_blocks_per_sm": [ctypes.c_void_p]}


class FusedKernel:
  """The generated kernel of one scene, at LANES and at WIDE lanes per
  world: both sources are registered with `_build` at construction; each is
  compiled with nvcc at the first launch that takes it. `_build.build()`
  compiles the LANES build with the other kernels, in parallel, and leaves
  the wide one to its first launch. `name` and `source` are the LANES
  build's, `names[lanes]` each build's, `called[lanes]` whether it calls
  the cone solve out of line (`solve_called`)."""

  def __init__(self, sd: _StaticData):
    self.sd = sd
    self.smem_bytes = smem_bytes(sd)             # per 32-thread block of the LANES build
    head, body, self.ops_per_world, self.loads_per_world = _source_body(sd)
    self.sources = {n: _with_head(sd, head, body, n) for n in (LANES, WIDE)}
    self.called = {n: solve_called(sd, n) for n in (LANES, WIDE)}
    self.names = {n: _build.add_generated("fused_step", src, _SYMBOLS, _FLAGS, lazy=n == WIDE)
                  for n, src in self.sources.items()}
    self.source, self.name = self.sources[LANES], self.names[LANES]
    self._waves = {}                             # device -> [SMs, bound, blocks per SM]

  def lanes(self, B: int, device) -> int:
    """Lanes per world for a launch of B worlds on `device`: `lanes_for` with
    the card's SMs, the wide build's resident blocks per SM (the occupancy
    API, read once a device) and whether the source loads heights. A batch past what the wide build
    could hold in one wave before its registers count (SM_BLOCKS blocks an
    SM, and no more than the SM's warps and shared memory take) takes LANES
    without building the wide source."""
    wave = self._waves.get(device)
    if wave is None:
      props = torch.cuda.get_device_properties(device)
      bound = min(SM_BLOCKS, props.max_threads_per_multi_processor // BLOCK,
                  SM_SMEM // (smem_bytes(self.sd, WIDE) + 1024))
      wave = self._waves[device] = [props.multi_processor_count, bound, None]
    sms, bound, blocks = wave
    probes = self.loads_per_world > 0
    if lanes_for(B, sms, bound, probes) == LANES:
      return LANES
    if blocks is None:
      n = ctypes.c_int(0)
      with torch.cuda.device(device):
        rc = _build.load(self.names[WIDE]).fused_step_blocks_per_sm(ctypes.byref(n))
      if rc != 0:
        raise RuntimeError(f"fused_step occupancy query failed: cudaError {rc}")
      blocks = wave[2] = n.value
    return lanes_for(B, sms, blocks, probes)

  def launch(self, q, u, tau, pd, heights=None):
    """(q', u') for float32 CUDA tensors q (B, nq), u, tau, pd (B, nv) and,
    on a heightmap scene, heights (B, nx, ny). A heights tensor whose world
    stride is 0 (`field.heights.expand(B, nx, ny)`) is read without a copy.
    The build follows the batch (`lanes`)."""
    return self.launch_build(None, q, u, tau, pd, heights)

  def launch_build(self, lanes, q, u, tau, pd, heights=None):
    """`launch` through the build at `lanes` lanes per world (LANES or
    WIDE), whichever the batch would take; None: the batch's (`lanes`). The
    card's checks launch both builds on the same inputs with it."""
    sd = self.sd
    B = q.shape[0]
    ins = {"q": (q, (B, sd.nq)), "u": (u, (B, sd.nv)), "tau": (tau, (B, sd.nv))}
    if sd.use_pd:
      ins["pd"] = (pd, (B, sd.nv))
    if sd.hm is not None:
      ins["heights"] = (heights, (B, sd.hm.nx, sd.hm.ny))
    elif heights is not None:
      raise ValueError("heights given to the kernel of a scene without a heightmap")
    for name, (x, shape) in ins.items():
      if x is None:
        raise ValueError(f"{name} is missing")
      if not x.is_cuda or x.device != q.device:
        raise ValueError(f"{name} is on {x.device}, q on {q.device}")
      if x.dtype != torch.float32:
        raise TypeError(f"the fused CUDA step takes float32 only; {name} is {x.dtype}")
      if tuple(x.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
    q, u, tau = q.contiguous(), u.contiguous(), tau.contiguous()
    pd = pd.contiguous() if sd.use_pd else None
    hts, stride = None, 0
    if sd.hm is not None:
      field = sd.hm.nx * sd.hm.ny
      if heights.stride()[1:] != (sd.hm.ny, 1) or heights.stride(0) not in (0, field):
        heights = heights.contiguous()
      hts, stride = heights.data_ptr(), heights.stride(0)
    qo = torch.empty_like(q)
    uo = torch.empty_like(u)
    lanes = self.lanes(B, q.device) if lanes is None else lanes
    lib = _build.load(self.names[lanes])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with profiling.span("k1.enqueue", B=B, lanes=lanes,
                        solve="called" if self.called[lanes] else "inlined"):
      rc = lib.fused_step_launch(q.data_ptr(), u.data_ptr(), tau.data_ptr(),
                                 pd.data_ptr() if pd is not None else None,
                                 hts, stride, qo.data_ptr(), uo.data_ptr(), B, stream)
    if rc != 0:
      raise RuntimeError(f"fused_step kernel launch failed: cudaError {rc}")
    make_step_batch_fused.launches += 1
    make_step_batch_fused.launches_wide += int(lanes == WIDE)
    make_step_batch_fused.launches_called += int(self.called[lanes])
    return qo, uo


class _FusedFn(torch.autograd.Function):

  @staticmethod
  def forward(ctx, q, u, tau, pd, heights, step):
    ctx.step = step
    ctx.save_for_backward(q, u, tau, pd, heights)
    if q.is_cuda:
      return step.kernel.launch(q, u, tau, pd, heights)
    return _fused_plain(step.sd, q, u, tau, pd, heights)

  @staticmethod
  def backward(ctx, dq, du):
    step = ctx.step
    inputs = [None if x is None else x.detach().requires_grad_(need)
              for x, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
    diff = [x for x in inputs if x is not None and x.requires_grad]
    q, u, tau, pd, heights = inputs
    with torch.enable_grad():
      s = pipeline.step_batch(step.scene, State(q=q, u=u, t=torch.zeros_like(q[:, 0])),
                              tau, pd, step.config, field_heights=heights)
      grads = iter(torch.autograd.grad((s.q, s.u), diff, (dq, du), allow_unused=True))
    return tuple(next(grads) if x is not None and x.requires_grad else None
                 for x in inputs) + (None,)


class FusedStep:
  """step(state, tau, pd_target=None, field_heights=None) -> State: one
  physics step of a batch of worlds, as pipeline.step_batch computes it (see
  make_step_batch_fused)."""

  def __init__(self, scene, config, use_pd: bool):
    self.scene, self.config, self.use_pd = scene, config, use_pd
    self.sd = _analyze(scene, config, use_pd)
    smem_bytes(self.sd)                   # a block must hold its worlds' shared arrays
    self._kernel = None

  @property
  def kernel(self) -> FusedKernel:
    """The scene's kernel (source generated and registered at first use)."""
    if self._kernel is None:
      self._kernel = FusedKernel(self.sd)
    return self._kernel

  def heights(self, q, field_heights=None):
    """The (B, nx, ny) heights a step of the batch q reads: `field_heights`
    (checked by pipeline.scene_field), or the scene's field for every world
    (expanded, not copied); None for a scene without a heightmap."""
    field = pipeline.scene_field(self.scene, field_heights, q.device)
    if field is None:
      return None
    B = q.shape[0]
    if field_heights is None:
      return field.heights.expand((B,) + field.shape)
    if field_heights.shape[0] != B:
      raise ValueError(f"field_heights holds {field_heights.shape[0]} worlds, the state {B}")
    return field_heights

  def __call__(self, state: State, tau, pd_target=None, field_heights=None) -> State:
    with profiling.span("k1.step", B=state.q.shape[0]):
      pd = pd_target if self.use_pd else None
      if self.use_pd and pd is None:
        raise ValueError("this fused step was built with use_pd=True: pass pd_target")
      hts = self.heights(state.q, field_heights)
      q, u = _FusedFn.apply(state.q, state.u, tau, pd, hts, self)
      return State(q=q, u=u, t=state.t + self.sd.dt)


def make_step_batch_fused(scene, config=None, use_pd: bool = True) -> FusedStep:
  """Fused replacement for pipeline.step_batch on eligible scenes (K1a on a
  plane, K1b for a sphere against a sphere, a box or a capsule, K1c on a
  heightmap, cylinders, cones and convex meshes included).

  Returns step(state, tau, pd_target, field_heights=None) -> State
  (pd_target ignored when use_pd=False). On a heightmap scene
  `field_heights` (B, nx, ny) gives each world its own terrain; None uses
  the scene's field for every world. CUDA tensors (float32) launch the
  generated kernel and count one launch in `make_step_batch_fused.launches`
  (and in `.launches_wide` where it took the wide build, in
  `.launches_called` where that build calls the cone solve out of line,
  `solve_called`); CPU tensors run
  the twin `_fused_plain`. Gradients differentiate
  pipeline.step_batch with the same heights (its contact solve's backward
  runs `_mf_pure`), the forward/backward split of the JAX package's custom
  VJP. Raises FusedStepUnsupported for scenes outside the kernel's classes."""
  config = config if config is not None else pipeline.StepConfig()
  return FusedStep(scene, config, use_pd)


make_step_batch_fused.launches = 0
make_step_batch_fused.launches_wide = 0
make_step_batch_fused.launches_called = 0


def fused_step_cost(sd: _StaticData, B: int, ops_per_world: int,
                    loads_per_world: int = 0):
  """(bytes, operations) of one fused step of B worlds, for its bound: each
  float32 input (q, u, tau and pd when used) read once and each output
  (q', u') written once; on a heightmap, the `loads_per_world` heights each
  world's probes load from its own field (fewer distinct bytes where
  samples share a cell; either way far below the operations' time); the
  operations the kernel's source runs per world (its own tally) times B."""
  n_in = sd.nq + 2 * sd.nv + (sd.nv if sd.use_pd else 0)
  return 4 * B * (n_in + sd.nq + sd.nv + loads_per_world), B * ops_per_world
