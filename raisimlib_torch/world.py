"""World -> Scene: the public scene-building API of the port.

Counterpart of the main-path part of raisimlib_tpu/world.py. `World.add_*`
calls accumulate object specs on the host; `World.compile()` merges them into
one forest `RobotModel` plus static geometry tables on the world's device and
returns a `Scene`, whose `step` / `step_batch` advance states. The other
`add_*` objects, wires, pins and heightmaps are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch

from raisimlib_torch._device import check_matmul_precision, resolve_device
from raisimlib_torch.models.model import RobotModel, build_model, joint_nq, joint_nv
from raisimlib_torch.ops import collision as coll
from raisimlib_torch.ops import constraints as cs
from raisimlib_torch.ops import integrator
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
    self._nq = 0
    self._nv = 0

  # -- materials ------------------------------------------------------------
  def add_material(self, mu: float, restitution: float = 0.0,
                   threshold: float = 0.001) -> int:
    self._materials.append((float(mu), float(restitution), float(threshold)))
    return len(self._materials) - 1

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

  def add_ground(self, height: float = 0.0, material: int = 0) -> None:
    self._geoms.append(coll.GeomSpec(-1, coll.GEOM_PLANE,
                                     np.array([height, 0.0, 0.0, 0.0]),
                                     np.zeros(3), np.eye(3), material))

  # -- compile --------------------------------------------------------------
  def compile(self, joint_limits: bool = True) -> "Scene":
    """Freeze to a Scene on the world's device. `joint_limits=True` adds one
    unilateral solver row per dof with a finite URDF position limit.

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
        constraints=cs.build_tables(model, joint_limits),
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
  objects: tuple = ()         # (name, q0, q1, v0, v1, body_start) per object

  @property
  def device(self) -> torch.device:
    return self.model.device

  def init_state(self, q=None, u=None) -> State:
    return integrator.init_state(self.model, q, u)

  def set_pd_gains(self, kp, kd) -> "Scene":
    """Per-dof PD gains; scalars broadcast over the dofs. Returns a new Scene."""
    nv, dtype, dev = self.model.nv, self.model.dtype, self.device

    def vec(x):
      x = torch.as_tensor(x, dtype=dtype, device=dev)
      return x.expand(nv).clone()

    return dataclasses.replace(self, kp=vec(kp), kd=vec(kd))

  def step(self, state: State, tau=None, pd_target=None, f_ext_w=None) -> State:
    """One reference physics step of ONE world (q (nq,), u (nv,))."""
    from raisimlib_torch.ops import pipeline

    if f_ext_w is not None:
      raise NotImplementedError("external wrenches are not ported to "
                                "raisimlib_torch yet: ROADMAP.md")
    q = state.q
    if tau is None:
      tau = torch.zeros(self.model.nv, dtype=q.dtype, device=q.device)
    s = pipeline.step(self, State(q=q[None], u=state.u[None], t=state.t[None]),
                      tau[None], None if pd_target is None else pd_target[None])
    return State(q=s.q[0], u=s.u[0], t=s.t[0])

  def step_batch(self, state: State, tau=None, pd_target=None,
                 field_heights=None) -> State:
    """Batched step (leading batch axis on state / tau / pd_target) whose
    contact solve is the CUDA kernel on the card."""
    from raisimlib_torch.ops import pipeline

    if tau is None:
      tau = torch.zeros((state.q.shape[0], self.model.nv), dtype=state.q.dtype,
                        device=state.q.device)
    return pipeline.step_batch(self, state, tau, pd_target,
                               field_heights=field_heights)
