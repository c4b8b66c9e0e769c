"""Build the port's Scene from arrays: carry a scene across from numpy.

`scene_from_numpy` takes the numeric tables of a scene as numpy arrays and
its static layout as plain Python, so that a scene built elsewhere (the JAX
package's `World.compile()`, flattened by the caller) becomes the port's
Scene on `device` without this package importing the other one.

arrays: model tables (X_rot, X_pos, axis, inertia, mass, actuated,
  torque_limit, joint_lo, joint_hi, q_init), geom tables (geom_params,
  geom_offset_pos, geom_offset_rot), materials, gravity, kp, kd.
static: name, parent, joint_types, q_adr, v_adr, nq, nv, body_names, gtype,
  geom_body, geom_material, pairs, constraints (the 7 fields of
  ConstraintTables, in order), dt, objects.
"""

from __future__ import annotations

import numpy as np
import torch

from raisimlib_torch._device import resolve_device
from raisimlib_torch.models.model import TENSOR_FIELDS, RobotModel
from raisimlib_torch.ops import collision as coll
from raisimlib_torch.ops import constraints as cs
from raisimlib_torch.world import Scene


def scene_from_numpy(arrays: dict, static: dict, device=None, dtype=None) -> Scene:
  dev = resolve_device(device)
  dtype = dtype or torch.float32

  def t(name):
    return torch.as_tensor(np.array(arrays[name]), dtype=dtype, device=dev)

  model = RobotModel(
      name=static["name"], parent=tuple(static["parent"]),
      joint_types=tuple(int(j) for j in static["joint_types"]),
      q_adr=tuple(static["q_adr"]), v_adr=tuple(static["v_adr"]),
      nq=int(static["nq"]), nv=int(static["nv"]),
      body_names=tuple(static["body_names"]),
      **{f: t(f) for f in TENSOR_FIELDS})
  geoms = coll.GeomTable(
      gtype=tuple(static["gtype"]), body=tuple(static["geom_body"]),
      material=tuple(static["geom_material"]), params=t("geom_params"),
      offset_pos=t("geom_offset_pos"), offset_rot=t("geom_offset_rot"))
  tabs = cs.ConstraintTables(*(tuple(f) for f in static["constraints"]))
  if tabs.wires or tabs.pins or tabs.compliant:
    raise cs._unported("wires and pins")
  return Scene(model=model, geoms=geoms, pairs=tuple(map(tuple, static["pairs"])),
               materials=t("materials"), gravity=t("gravity"), dt=float(static["dt"]),
               kp=t("kp"), kd=t("kd"), constraints=tabs,
               objects=tuple(map(tuple, static.get("objects", ()))))
