"""Build the port's Scene or RobotModel from arrays: carry one across from numpy.

`scene_from_numpy` takes the numeric tables of a scene as numpy arrays and
its static layout as plain Python, so that a scene built elsewhere (the JAX
package's `World.compile()`, flattened by the caller) becomes the port's
Scene on `device` without this package importing the other one.
`model_from_numpy` does the same for a bare RobotModel (a primitive of
models/primitives.py, say): its half of the tables below.

arrays: model tables (X_rot, X_pos, axis, inertia, mass, actuated,
  torque_limit, joint_lo, joint_hi, q_init), geom tables (geom_params,
  geom_offset_pos, geom_offset_rot, and geom_mesh_verts (ng, MAX_MESH_VERTS,
  3) when the scene has meshes), materials, gravity, kp, kd.
static: name, parent, joint_types, q_adr, v_adr, nq, nv, body_names, gtype,
  geom_body, geom_material, pairs, constraints (the 7 fields of
  ConstraintTables, in order), dt, objects, and geom_mesh_vcount (vertices
  per geom, 0 for non-mesh geoms) with geom_mesh_verts.
A heightmap terrain, when the scene has one: arrays field_heights (nx, ny)
and field_center (2,), static field_size (size_x, size_y).
"""

from __future__ import annotations

import numpy as np
import torch

from raisimlib_torch._device import resolve_device
from raisimlib_torch.models.model import TENSOR_FIELDS, RobotModel
from raisimlib_torch.ops import collision as coll
from raisimlib_torch.ops import constraints as cs
from raisimlib_torch.ops.heightmap import HeightField
from raisimlib_torch.world import Scene


def model_from_numpy(arrays: dict, static: dict, device=None, dtype=None) -> RobotModel:
  """The RobotModel of the model tables in `arrays` (TENSOR_FIELDS) and the
  static fields name, parent, joint_types, q_adr, v_adr, nq, nv and
  body_names, on `device` (None: the card)."""
  dev = resolve_device(device)
  dtype = dtype or torch.float32
  return RobotModel(
      name=static["name"], parent=tuple(static["parent"]),
      joint_types=tuple(int(j) for j in static["joint_types"]),
      q_adr=tuple(static["q_adr"]), v_adr=tuple(static["v_adr"]),
      nq=int(static["nq"]), nv=int(static["nv"]),
      body_names=tuple(static["body_names"]),
      **{f: torch.as_tensor(np.array(arrays[f]), dtype=dtype, device=dev)
         for f in TENSOR_FIELDS})


def scene_from_numpy(arrays: dict, static: dict, device=None, dtype=None) -> Scene:
  dev = resolve_device(device)
  dtype = dtype or torch.float32

  def t(name):
    return torch.as_tensor(np.array(arrays[name]), dtype=dtype, device=dev)

  model = model_from_numpy(arrays, static, dev, dtype)
  geoms = coll.GeomTable(
      gtype=tuple(static["gtype"]), body=tuple(static["geom_body"]),
      material=tuple(static["geom_material"]), params=t("geom_params"),
      offset_pos=t("geom_offset_pos"), offset_rot=t("geom_offset_rot"),
      mesh_verts=t("geom_mesh_verts") if "geom_mesh_verts" in arrays else None,
      mesh_vcount=tuple(int(n) for n in static.get("geom_mesh_vcount", ())))
  lim = [tuple(f) for f in static["constraints"][:4]]
  wires, pins, compliant = static["constraints"][4:]
  tabs = cs.ConstraintTables(*lim, tuple(cs.WireSpec(*w) for w in wires),
                             tuple(cs.PinSpec(*p) for p in pins),
                             tuple(cs.CompliantWireSpec(*c) for c in compliant))
  field = None
  if "field_heights" in arrays:
    size_x, size_y = (float(x) for x in static["field_size"])
    field = HeightField(heights=t("field_heights"), center=t("field_center"),
                        size_x=size_x, size_y=size_y)
  return Scene(model=model, geoms=geoms, pairs=tuple(map(tuple, static["pairs"])),
               materials=t("materials"), gravity=t("gravity"), dt=float(static["dt"]),
               kp=t("kp"), kd=t("kd"), constraints=tabs, field=field,
               objects=tuple(map(tuple, static.get("objects", ()))))
