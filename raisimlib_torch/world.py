"""World -> Scene: the public scene-building API of the port.

Counterpart of raisimlib_tpu/world.py: articulated systems, loose spheres,
boxes (also static ones), capsules, cylinders, cones, convex meshes and
compounds, the ground plane and a heightmap, stiff wires, pins and
compliant wires. `World.add_*` calls accumulate object specs on the host;
`World.compile()` merges them into one forest `RobotModel` (a loose body is
a FREE-joint root) plus static geometry and constraint tables on the
world's device and returns a `Scene`, whose `step` / `step_batch` advance
states, with external wrenches if given (`Scene.external_force`). A world
holds at most one heightmap (`add_heightmap`); the compiled Scene carries it
as `Scene.field`, and `Scene.replace(field=scene.field.replace(heights=h))`
swaps in other heights. Every pair of geoms collides (ops/collision.py);
scenes outside the fused step's class (box-box, capsule-capsule, the
support-function pairs, wires, pins and compliant wires, as in the JAX
package) step on the K2 path.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import List, Optional, Sequence

import numpy as np
import torch

from raisimlib_torch._device import check_matmul_precision, resolve_device
from raisimlib_torch.models.model import (JointType, RobotModel, build_model, joint_nq,
                                          joint_nv)
from raisimlib_torch.ops import collision as coll
from raisimlib_torch.ops import constraints as cs
from raisimlib_torch.ops import integrator
from raisimlib_torch.ops.heightmap import HeightField
from raisimlib_torch.ops.integrator import State


@dataclasses.dataclass(frozen=True)
class ObjectHandle:
  """Returned by add_* — where the object landed in the merged model."""

  name: str
  body_start: int
  q_slice: slice
  v_slice: slice


class World:
  """Accumulates objects, then compiles to a `Scene` on `device`.

  `device=None` means the CUDA device; without one, construction raises
  (pass device="cpu" to run on the CPU)."""

  def __init__(self, dt: float = 0.001, gravity=(0.0, 0.0, -9.81),
               dtype=torch.float32, self_collision: bool = False, device=None):
    self.device = resolve_device(device)
    self.dt = float(dt)
    self.self_collision = bool(self_collision)
    self.gravity = np.asarray(gravity, dtype=np.float64)
    self.dtype = dtype
    self._bodies: List[dict] = []
    self._geoms: List[coll.GeomSpec] = []
    self._handles: List[ObjectHandle] = []
    self._materials: List[tuple] = [(0.8, 0.0, 0.001)]  # (mu, restitution, threshold)
    self._pair_props: dict = {}
    self._field: Optional[HeightField] = None
    self._wires: List[cs.WireSpec] = []
    self._pins: List[cs.PinSpec] = []
    self._compliant: List[cs.CompliantWireSpec] = []
    self._nq = 0
    self._nv = 0

  # -- materials ------------------------------------------------------------
  def add_material(self, mu: float, restitution: float = 0.0,
                   threshold: float = 0.001) -> int:
    self._materials.append((float(mu), float(restitution), float(threshold)))
    return len(self._materials) - 1

  def set_default_friction(self, mu: float) -> None:
    """The friction coefficient of material 0, the default of every geom."""
    m = self._materials[0]
    self._materials[0] = (float(mu), m[1], m[2])

  def set_material_pair_prop(self, mat_a: int, mat_b: int, mu: float,
                             restitution: float = 0.0, threshold: float = 0.001):
    key = (min(mat_a, mat_b), max(mat_a, mat_b))
    self._pair_props[key] = (float(mu), float(restitution), float(threshold))

  def _material_pair_table(self) -> np.ndarray:
    """(n_mat, n_mat, 3); unset pairs combine as mu = sqrt(mu_i mu_j),
    e = max, threshold = max."""
    n = len(self._materials)
    tab = np.zeros((n, n, 3))
    for i in range(n):
      for j in range(n):
        key = (min(i, j), max(i, j))
        if key in self._pair_props:
          tab[i, j] = self._pair_props[key]
        else:
          mi, mj = self._materials[i], self._materials[j]
          tab[i, j] = (np.sqrt(mi[0] * mj[0]), max(mi[1], mj[1]), max(mi[2], mj[2]))
    return tab

  # -- objects --------------------------------------------------------------
  def add_articulated_system(self, bodies: Sequence[dict], name: str = "robot",
                             geoms: Sequence[dict] = ()) -> ObjectHandle:
    """Add a robot from build_model-format body specs + collision geom dicts
    (body (local index), gtype, params, offset_pos, offset_rot, material)."""
    ofs = len(self._bodies)
    nq0, nv0 = self._nq, self._nv
    for b in bodies:
      b = dict(b)
      if b["parent"] >= 0:
        b["parent"] = b["parent"] + ofs
      self._bodies.append(b)
      self._nq += joint_nq(b["joint"])
      self._nv += joint_nv(b["joint"])
    h = ObjectHandle(name, ofs, slice(nq0, self._nq), slice(nv0, self._nv))
    self._handles.append(h)
    obj = len(self._handles) - 1
    for g in geoms:
      self._geoms.append(coll.GeomSpec(
          body=g["body"] + ofs, gtype=int(g["gtype"]),
          params=np.resize(np.asarray(g.get("params", []), dtype=np.float64), 4),
          offset_pos=np.asarray(g.get("offset_pos", np.zeros(3)), dtype=np.float64),
          offset_rot=np.asarray(g.get("offset_rot", np.eye(3)), dtype=np.float64),
          material=int(g.get("material", 0)), obj=obj))
    return h

  def _add_free_body(self, name: str, mass: float, inertia, pos, gtype: int, params,
                     material: int, rot=None, com=(0.0, 0.0, 0.0),
                     mesh=None) -> ObjectHandle:
    """One FREE-joint body at `pos` (identity orientation) with one geom."""
    spec = dict(parent=-1, joint=JointType.FREE, mass=mass, com=list(com),
                inertia=inertia, actuated=False, name=name,
                q_init=list(pos) + [1.0, 0.0, 0.0, 0.0])
    h = self.add_articulated_system([spec], name)
    padded = np.zeros(4)
    padded[:len(params)] = params
    self._geoms.append(coll.GeomSpec(
        h.body_start, gtype, padded, np.zeros(3),
        np.eye(3) if rot is None else np.asarray(rot, np.float64), material, mesh=mesh))
    return h

  def add_sphere(self, radius: float, mass: float, name="sphere", material=0,
                 pos=(0.0, 0.0, 1.0)) -> ObjectHandle:
    """A loose sphere (RaiSim `World::addSphere`)."""
    return self._add_free_body(name, mass, 0.4 * mass * radius * radius * np.eye(3), pos,
                               coll.GEOM_SPHERE, [radius], material)

  def add_box(self, half_extents, mass: float, name="box", material=0,
              pos=(0.0, 0.0, 1.0), static: bool = False,
              rot=None) -> Optional[ObjectHandle]:
    """A box rigid body; its geom turned by `rot` in the body frame.
    `static=True` makes it immovable world geometry at (pos, rot) with no
    state (RaiSim's BodyType::STATIC: ramps, platforms, obstacles): it
    collides with every dynamic geom, adds no dofs, and the call returns
    None."""
    hx, hy, hz = half_extents
    if static:
      self._geoms.append(coll.GeomSpec(
          -1, coll.GEOM_BOX, np.array([hx, hy, hz, 0.0]), np.asarray(pos, np.float64),
          np.eye(3) if rot is None else np.asarray(rot, np.float64), material))
      return None
    inertia = mass / 3.0 * np.diag([hy * hy + hz * hz, hx * hx + hz * hz, hx * hx + hy * hy])
    return self._add_free_body(name, mass, inertia, pos, coll.GEOM_BOX, [hx, hy, hz],
                               material, rot)

  def add_capsule(self, radius: float, half_length: float, mass: float, name="capsule",
                  material=0, pos=(0.0, 0.0, 1.0)) -> ObjectHandle:
    """A loose capsule along its body z axis; its inertia is the solid
    cylinder's of the same radius and length (the JAX package's)."""
    r2, length = radius * radius, 2.0 * half_length
    ixx = mass * (3.0 * r2 + length * length) / 12.0
    return self._add_free_body(name, mass, np.diag([ixx, ixx, 0.5 * mass * r2]), pos,
                               coll.GEOM_CAPSULE, [radius, half_length], material)

  def add_cylinder(self, radius: float, half_length: float, mass: float, name="cylinder",
                   material=0, pos=(0.0, 0.0, 1.0)) -> ObjectHandle:
    """A loose flat-capped cylinder along its body z axis (RaiSim
    `World::addCylinder`)."""
    r2, length = radius * radius, 2.0 * half_length
    ixx = mass * (3.0 * r2 + length * length) / 12.0
    return self._add_free_body(name, mass, np.diag([ixx, ixx, 0.5 * mass * r2]), pos,
                               coll.GEOM_CYLINDER, [radius, half_length], material)

  def add_cone(self, radius: float, height: float, mass: float, name="cone",
               material=0, pos=(0.0, 0.0, 1.0)) -> ObjectHandle:
    """A loose solid cone along its body +z axis (RaiSim `World::addCone`),
    its origin at the COM: the base ring of `radius` at z = -height/4, the
    apex at z = +3 height/4."""
    r2 = radius * radius
    ixx = mass * (3.0 / 20.0 * r2 + 3.0 / 80.0 * height * height)
    return self._add_free_body(name, mass, np.diag([ixx, ixx, 0.3 * mass * r2]), pos,
                               coll.GEOM_CONE, [radius, height], material)

  def add_mesh(self, vertices, mass: float, name="mesh", material=0, pos=(0.0, 0.0, 1.0),
               inertia=None, com=(0.0, 0.0, 0.0)) -> ObjectHandle:
    """A loose convex mesh from its hull vertices (n, 3) in the body frame
    (RaiSim `World::addMesh`); the narrow phase takes at most
    collision.MAX_MESH_VERTS of them (collision.hull_support_sample).
    `inertia` (3, 3) about the COM `com` defaults to the inertia of the
    vertices' bounding box (an approximation: pass the true tensor)."""
    V = np.asarray(vertices, dtype=np.float64).reshape(-1, 3)
    if len(V) < 4:
      raise ValueError(f"a mesh needs >= 4 vertices, got {len(V)}")
    if inertia is None:
      ext = V.max(axis=0) - V.min(axis=0)
      inertia = mass / 12.0 * np.diag([ext[1] ** 2 + ext[2] ** 2, ext[0] ** 2 + ext[2] ** 2,
                                       ext[0] ** 2 + ext[1] ** 2])
    return self._add_free_body(name, mass, np.asarray(inertia, np.float64), pos,
                               coll.GEOM_MESH, [], material, com=com, mesh=V)

  def add_compound(self, children, mass: float, name="compound", material=0,
                   pos=(0.0, 0.0, 1.0), inertia=None,
                   com=(0.0, 0.0, 0.0)) -> ObjectHandle:
    """A rigid body of several primitive geoms (RaiSim `Compound`): one
    FREE-joint body, one geom per child. Each child is a dict {type:
    "sphere" | "box" | "capsule" | "cylinder", params: sphere [r], box [hx,
    hy, hz], capsule or cylinder [r, hl], pos (3,), rot (3, 3) optional,
    material optional}. `inertia` (3, 3) about the COM `com` defaults to
    the children's primitive inertias (a capsule as the cylinder of its
    radius and half-length), the mass split by volume, moved to the COM by
    the parallel-axis theorem."""
    def volume(t, p):
      if t == "sphere":
        return 4.0 / 3.0 * np.pi * p[0] ** 3
      if t == "box":
        return 8.0 * p[0] * p[1] * p[2]
      if t == "capsule":
        return np.pi * p[0] ** 2 * (2 * p[1]) + 4.0 / 3.0 * np.pi * p[0] ** 3
      if t == "cylinder":
        return np.pi * p[0] ** 2 * (2 * p[1])
      raise ValueError(f"unknown compound child type {t!r}")

    def prim_inertia(t, p, m):
      if t == "sphere":
        return 0.4 * m * p[0] ** 2 * np.eye(3)
      if t == "box":
        hx, hy, hz = p
        return m / 3.0 * np.diag([hy * hy + hz * hz, hx * hx + hz * hz, hx * hx + hy * hy])
      r, length = p[0], 2 * p[1]
      ixx = m * (3 * r * r + length * length) / 12.0
      return np.diag([ixx, ixx, 0.5 * m * r * r])

    gtypes = {"sphere": coll.GEOM_SPHERE, "box": coll.GEOM_BOX,
              "capsule": coll.GEOM_CAPSULE, "cylinder": coll.GEOM_CYLINDER}
    vols = [volume(c["type"], c["params"]) for c in children]
    if inertia is None:
      inertia = np.zeros((3, 3))
      for c, v in zip(children, vols):
        mi = mass * v / sum(vols)
        ci = np.asarray(c.get("pos", (0, 0, 0)), dtype=np.float64) - np.asarray(com)
        R = np.asarray(c.get("rot", np.eye(3)), dtype=np.float64)
        inertia = inertia + (R @ prim_inertia(c["type"], c["params"], mi) @ R.T
                             + mi * (np.dot(ci, ci) * np.eye(3) - np.outer(ci, ci)))
    spec = dict(parent=-1, joint=JointType.FREE, mass=mass, com=list(com),
                inertia=np.asarray(inertia, np.float64), actuated=False, name=name,
                q_init=list(pos) + [1.0, 0.0, 0.0, 0.0])
    h = self.add_articulated_system([spec], name)
    obj = len(self._handles) - 1
    for c in children:
      self._geoms.append(coll.GeomSpec(
          h.body_start, gtypes[c["type"]],
          np.resize(np.asarray(c["params"], dtype=np.float64), 4),
          np.asarray(c.get("pos", np.zeros(3)), dtype=np.float64),
          np.asarray(c.get("rot", np.eye(3)), dtype=np.float64),
          int(c.get("material", material)), obj=obj))
    return h

  def add_ground(self, height: float = 0.0, material: int = 0) -> None:
    self._geoms.append(coll.GeomSpec(-1, coll.GEOM_PLANE,
                                     np.array([height, 0.0, 0.0, 0.0]),
                                     np.zeros(3), np.eye(3), material))

  def add_heightmap(self, field: HeightField, material: int = 0) -> None:
    """Add a heightfield terrain (RaiSim `World::addHeightMap`); at most one
    per world. Its heights and centre move to the world's device and dtype.

    Tunneling guard: the narrow phase has no continuous collision detection.
    A near-vertical face (a stairs riser) is a one-cell band, and a body that
    crosses it in one step passes through. If some adjacent samples rise
    more than 45 degrees, this warns with the speed above which that can
    happen (one cell per step)."""
    if self._field is not None:
      raise ValueError("a world holds one heightmap")
    H = np.asarray(torch.as_tensor(field.heights).detach().cpu(), dtype=np.float64)
    if H.ndim != 2 or min(H.shape) < 2:
      raise ValueError(f"heightmap heights must be (nx, ny) with nx, ny >= 2, "
                       f"got {H.shape}")
    dx = float(field.size_x) / (H.shape[0] - 1)
    dy = float(field.size_y) / (H.shape[1] - 1)
    grade = max(float(np.abs(np.diff(H, axis=0)).max()) / dx,
                float(np.abs(np.diff(H, axis=1)).max()) / dy)
    if grade > 1.0:
      v_max = min(dx, dy) / self.dt
      warnings.warn(
          f"heightmap contains near-vertical faces (max cell slope {grade:.1f}); "
          f"there is no continuous collision detection, so bodies moving faster "
          f"than ~{v_max:.1f} m/s (one cell of {min(dx, dy):.3f} m per dt={self.dt} s "
          f"step) can TUNNEL through a riser. Keep speeds below that bound, "
          f"reduce dt, or refine the grid.", stacklevel=2)
    self._field = HeightField(
        heights=torch.as_tensor(field.heights, dtype=self.dtype, device=self.device),
        center=torch.as_tensor(field.center, dtype=self.dtype, device=self.device),
        size_x=float(field.size_x), size_y=float(field.size_y))
    self._geoms.append(coll.GeomSpec(-1, coll.GEOM_HEIGHTMAP, np.zeros(4),
                                     np.zeros(3), np.eye(3), material))

  # -- constraints ----------------------------------------------------------
  def add_stiff_wire(self, body_a: int, pos_a, body_b: int, pos_b, length: float) -> None:
    """An inextensible cable between two body-local points (RaiSim
    `World::addStiffWire`): a unilateral tension row of the contact solve;
    it resists stretch and never pushes. Body -1 anchors an end to the
    world (its point in world coordinates)."""
    self._wires.append(cs.WireSpec(int(body_a), tuple(map(float, pos_a)), int(body_b),
                                   tuple(map(float, pos_b)), float(length)))

  def add_compliant_wire(self, body_a: int, pos_a, body_b: int, pos_b, length: float,
                         stiffness: float, damping: float = 0.0) -> None:
    """A spring-damper cable (RaiSim `CompliantLengthConstraint`): a force
    in the bias term, not a solver row; tension only."""
    self._compliant.append(cs.CompliantWireSpec(
        int(body_a), tuple(map(float, pos_a)), int(body_b), tuple(map(float, pos_b)),
        float(length), float(stiffness), float(damping)))

  def add_pin(self, body_a: int, pos_a, body_b: int, pos_b) -> None:
    """A ball joint (RaiSim `PinConstraint`): two body-local points held
    together by a bilateral row triplet of the solve. Body -1 pins to the
    world."""
    self._pins.append(cs.PinSpec(int(body_a), tuple(map(float, pos_a)), int(body_b),
                                 tuple(map(float, pos_b))))

  # -- compile --------------------------------------------------------------
  def compile(self, joint_limits: bool = True) -> "Scene":
    """Freeze to a Scene on the world's device. `joint_limits=True` adds one
    unilateral solver row per dof with a finite URDF position limit; the
    wires and pins add theirs after them.

    Raises if float32 matmuls may run in reduced precision (TF32): see
    `_device.check_matmul_precision`."""
    check_matmul_precision()
    dev, dtype = self.device, self.dtype
    model = build_model("scene", self._bodies, dtype=dtype, device=dev)
    return Scene(
        model=model,
        geoms=coll.build_geom_table(self._geoms, dtype=dtype, device=dev),
        pairs=coll.candidate_pairs(self._geoms, model, self.self_collision),
        materials=torch.as_tensor(self._material_pair_table(), dtype=dtype, device=dev),
        gravity=torch.as_tensor(self.gravity, dtype=dtype, device=dev),
        dt=self.dt,
        kp=torch.zeros(model.nv, dtype=dtype, device=dev),
        kd=torch.zeros(model.nv, dtype=dtype, device=dev),
        constraints=cs.build_tables(model, joint_limits, wires=self._wires, pins=self._pins,
                                    compliant=self._compliant),
        field=self._field,
        objects=tuple((h.name, h.q_slice.start, h.q_slice.stop, h.v_slice.start,
                       h.v_slice.stop, h.body_start) for h in self._handles))


@dataclasses.dataclass(frozen=True)
class Scene:
  """Compiled world: one forest model + static geometry/contact tables."""

  model: RobotModel
  geoms: coll.GeomTable
  pairs: tuple
  materials: torch.Tensor     # (n_mat, n_mat, 3): mu, restitution, threshold
  gravity: torch.Tensor
  dt: float
  kp: torch.Tensor            # (nv,) PD stiffness (0 disables)
  kd: torch.Tensor            # (nv,) PD damping
  constraints: cs.ConstraintTables = cs.EMPTY
  field: Optional[HeightField] = None   # the heightmap terrain, if any
  objects: tuple = ()         # (name, q0, q1, v0, v1, body_start) per object

  @property
  def device(self) -> torch.device:
    return self.model.device

  def replace(self, **changes) -> "Scene":
    """A copy with fields replaced, e.g. other terrain heights:
    `scene.replace(field=scene.field.replace(heights=h))`."""
    return dataclasses.replace(self, **changes)

  def init_state(self, q=None, u=None) -> State:
    return integrator.init_state(self.model, q, u)

  # -- objects and bodies by name (RaiSim's name registry, getState/setState)
  @property
  def object_names(self) -> tuple:
    return tuple(o[0] for o in self.objects)

  def _object(self, name: str):
    for o in self.objects:
      if o[0] == name:
        return o
    raise KeyError(f"unknown object {name!r}; registered: {self.object_names}")

  def object_state(self, state: State, name: str):
    """(q_obj, u_obj): the named object's slices of the state (views)."""
    _, q0, q1, v0, v1, _ = self._object(name)
    return state.q[..., q0:q1], state.u[..., v0:v1]

  def set_object_state(self, state: State, name: str, q=None, u=None) -> State:
    """A new State with the named object's coordinates and/or velocities
    replaced (the given state is not changed)."""
    _, q0, q1, v0, v1, _ = self._object(name)
    qn, un = state.q, state.u
    if q is not None:
      qn = qn.clone()
      qn[..., q0:q1] = torch.as_tensor(q, dtype=qn.dtype, device=qn.device)
    if u is not None:
      un = un.clone()
      un[..., v0:v1] = torch.as_tensor(u, dtype=un.dtype, device=un.device)
    return State(q=qn, u=un, t=state.t)

  def body_index(self, body_name: str) -> int:
    """Body index by name (RaiSim `getBodyIdx`)."""
    return self.model.body_names.index(body_name)

  def body_pose(self, state: State, body_name: str):
    """(R, p): the named body's world pose at `state` (one FK), for one
    world (q (nq,)) or a batch (q (B, nq))."""
    from raisimlib_torch.ops import dynamics

    single = state.q.ndim == 1
    q = state.q[None] if single else state.q
    kin = dynamics.fk(self.model, q)
    b = self.body_index(body_name)
    R, p = kin.R[:, b], kin.p[:, b]
    return (R[0], p[0]) if single else (R, p)

  def external_force(self, body_name: str, point_w, force_w, dtype=None) -> torch.Tensor:
    """(nb, 6) world-frame wrench table that applies `force_w` at the world
    point `point_w` on the named body, zero elsewhere: for
    `step(f_ext_w=...)` (RaiSim `setExternalForce`)."""
    from raisimlib_torch.ops import spatial as sp

    dtype = dtype or self.model.dtype
    b = self.body_index(body_name)
    out = torch.zeros((self.model.nb, 6), dtype=dtype, device=self.device)
    out[b] = sp.force_at_point(torch.as_tensor(point_w, dtype=dtype, device=self.device),
                               torch.as_tensor(force_w, dtype=dtype, device=self.device))
    return out

  def set_pd_gains(self, kp, kd) -> "Scene":
    """Per-dof PD gains; scalars broadcast over the dofs. Returns a new Scene."""
    nv, dtype, dev = self.model.nv, self.model.dtype, self.device

    def vec(x):
      x = torch.as_tensor(x, dtype=dtype, device=dev)
      return x.expand(nv).clone()

    return dataclasses.replace(self, kp=vec(kp), kd=vec(kd))

  def step(self, state: State, tau=None, pd_target=None, f_ext_w=None) -> State:
    """One reference physics step of ONE world (q (nq,), u (nv,)).
    `f_ext_w` (nb, 6): external wrenches, world frame at the world origin
    ([torque, force]; `external_force` builds one)."""
    from raisimlib_torch.ops import pipeline

    q = state.q
    if tau is None:
      tau = torch.zeros(self.model.nv, dtype=q.dtype, device=q.device)
    s = pipeline.step(self, State(q=q[None], u=state.u[None], t=state.t[None]),
                      tau[None], None if pd_target is None else pd_target[None],
                      f_ext_w=None if f_ext_w is None else f_ext_w[None])
    return State(q=s.q[0], u=s.u[0], t=s.t[0])

  def step_batch(self, state: State, tau=None, pd_target=None,
                 field_heights=None, f_ext_w=None) -> State:
    """Batched step (leading batch axis on state / tau / pd_target) whose
    contact solve is the CUDA kernel on the card. `field_heights` (B, nx, ny)
    gives each world its own terrain heights (default: the scene's field);
    `f_ext_w` (B, nb, 6) external wrenches as in `step`."""
    from raisimlib_torch.ops import pipeline

    if tau is None:
      tau = torch.zeros((state.q.shape[0], self.model.nv), dtype=state.q.dtype,
                        device=state.q.device)
    return pipeline.step_batch(self, state, tau, pd_target,
                               field_heights=field_heights, f_ext_w=f_ext_w)
