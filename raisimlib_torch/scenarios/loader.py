"""Scenario loader: a world, its physics and its run settings from one file.

Counterpart of raisimlib_tpu/scenarios/loader.py. RaiSim builds a world from
an XML description (`World(xmlFile)`); here one file per BASELINE config
holds what its example needs: world composition (objects, materials,
terrain), physics parameters (dt, gravity, PD gains) and controller and run
settings. `load()` parses and validates, `build_world()` builds the `World`
from the `world:` section; the other sections come back as plain dicts.

The scenarios of this package (`scenarios/*.json`) are JSON copies of the JAX
package's YAML files, read with the standard library's `json` (the card's
machine has no PyYAML); a test holds each copy equal to its YAML. A `.yaml`
or `.yml` path is read through PyYAML where it is installed.

Schema (all keys optional unless noted):
  name: str (required)
  world:
    dt: float (required)
    gravity: [x, y, z]
    objects:                # ordered; one entry per add_* call
      - {type: urdf, model: anymal|atlas, name: str}
      - {type: ground, height: float, material: int}
      - {type: sphere, radius, mass, pos, material}
      - {type: box, half_extents, mass, pos, material}
      - {type: capsule, radius, half_length, mass, pos, material}
      - {type: heightmap, size: [x,y], samples: [nx,ny]}
        # build_world builds the heightmap flat: the terrain's amplitude and
        # roughness come from the top-level `terrain:` section, which the
        # examples use to generate per-world heights; other heightmap keys
        # are refused at load time
    materials: [{mu, restitution, threshold}, ...]   # index 0 = default
    pd_gains: {kp, kd} or {groups: [{match, kp, kd}, ...]}
  controller: {...}          # free-form dict for the MPC layer
  run: {...}                 # free-form dict for the example
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

_SCENARIO_DIR = os.path.dirname(os.path.abspath(__file__))
_OBJECT_TYPES = ("urdf", "ground", "sphere", "box", "capsule", "heightmap")
_YAML = (".yaml", ".yml")


def scenario_path(name: str) -> str:
  """A scenario name (this package's JSON file) or a path, as a path."""
  if os.path.sep in name or name.endswith((".json",) + _YAML):
    return name
  return os.path.join(_SCENARIO_DIR, name + ".json")


def _read(path: str):
  if not path.endswith(_YAML):
    with open(path) as f:
      return json.load(f)
  try:
    import yaml
  except ImportError as e:
    stem = os.path.splitext(os.path.basename(path))[0]
    copy = os.path.join(_SCENARIO_DIR, stem + ".json")
    if not os.path.exists(copy):
      copy = os.path.splitext(path)[0] + ".json"
    raise ImportError(f"{path} is YAML and PyYAML is not installed; load its JSON copy "
                      f"{copy} instead") from e
  with open(path) as f:
    return yaml.safe_load(f)


def load(name: str) -> dict:
  """Load and validate a scenario by name (or explicit path)."""
  path = scenario_path(name)
  cfg = _read(path)
  if not isinstance(cfg, dict) or "name" not in cfg:
    raise ValueError(f"{path}: scenario must be a mapping with a 'name' key")
  if "world" in cfg:
    world = cfg["world"]
    if "dt" not in world:
      raise ValueError(f"{path}: world.dt is required")
    for obj in world.get("objects", ()):
      t = obj.get("type")
      if t not in _OBJECT_TYPES:
        raise ValueError(f"{path}: unknown object type {t!r} "
                         f"(expected one of {_OBJECT_TYPES})")
      if t == "heightmap":
        unknown = set(obj) - {"type", "size", "samples", "material", "name"}
        if unknown:
          raise ValueError(
              f"{path}: unknown heightmap key(s) {sorted(unknown)} — terrain "
              f"amplitude/roughness belongs in the top-level 'terrain:' "
              f"section, not the heightmap object")
  return cfg


def _builtin_model(name: str):
  """The built-in URDF generators (models/): (urdf text, jmap -> standing q)."""
  if name == "anymal":
    from raisimlib_torch.models import anymal

    return anymal.anymal_urdf(), lambda jmap: anymal.standing_q()
  if name == "atlas":
    from raisimlib_torch.models import atlas

    return atlas.atlas_urdf(), lambda jmap: atlas.standing_q(jmap)
  raise ValueError(f"unknown builtin model {name!r}")


def build_world(cfg: dict, dtype=torch.float32, device=None):
  """The `World` of the scenario's `world:` section on `device` (None: the
  card), and a dict of extras:
    info["standing_q"][name] -> the robot's reference pose (numpy)
    info["handles"][name], info["jmap"][name] -> its handle and dof map
    info["field"], info["terrain"] -> the HeightField and its object, if any
    info["pd_gains"] -> (kp, kd): floats, or (nv,) tensors for per-group gains
  """
  from raisimlib_torch.models.urdf import load_urdf
  from raisimlib_torch.world import World

  w = cfg.get("world", {})
  dtype = dtype or torch.float32
  world = World(dt=float(w["dt"]), gravity=tuple(w.get("gravity", (0.0, 0.0, -9.81))),
                dtype=dtype, device=device)
  info: dict = {"standing_q": {}, "field": None, "handles": {}}

  for i, mat in enumerate(w.get("materials", ())):
    if i == 0:
      world.set_default_friction(float(mat.get("mu", 0.8)))
    else:
      world.add_material(float(mat.get("mu", 0.8)), float(mat.get("restitution", 0.0)),
                         float(mat.get("threshold", 0.001)))

  for obj in w.get("objects", ()):
    t = obj["type"]
    if t == "urdf":
      urdf_xml, standing = _builtin_model(obj["model"])
      bodies, geoms, jmap = load_urdf(urdf_xml)
      name = obj.get("name", obj["model"])
      info["handles"][name] = world.add_articulated_system(bodies, name=name, geoms=geoms)
      info["standing_q"][name] = np.asarray(standing(jmap))
      info.setdefault("jmap", {})[name] = jmap
    elif t == "ground":
      world.add_ground(height=float(obj.get("height", 0.0)),
                       material=int(obj.get("material", 0)))
    elif t == "sphere":
      world.add_sphere(float(obj["radius"]), float(obj["mass"]),
                       name=obj.get("name", "sphere"), material=int(obj.get("material", 0)),
                       pos=tuple(obj.get("pos", (0.0, 0.0, 1.0))))
    elif t == "box":
      world.add_box(tuple(obj["half_extents"]), float(obj["mass"]),
                    name=obj.get("name", "box"), material=int(obj.get("material", 0)),
                    pos=tuple(obj.get("pos", (0.0, 0.0, 1.0))))
    elif t == "capsule":
      world.add_capsule(float(obj["radius"]), float(obj["half_length"]), float(obj["mass"]),
                        name=obj.get("name", "capsule"), material=int(obj.get("material", 0)),
                        pos=tuple(obj.get("pos", (0.0, 0.0, 1.0))))
    elif t == "heightmap":
      from raisimlib_torch.utils import terrain

      field = terrain.flat(0.0, size=tuple(obj.get("size", (12.0, 6.0))),
                           samples=tuple(obj.get("samples", (48, 24))), dtype=dtype,
                           device=world.device)
      world.add_heightmap(field, material=int(obj.get("material", 0)))
      info["field"] = field
      info["terrain"] = obj

  pd = w.get("pd_gains")
  if pd and "groups" in pd:
    # per-joint-group gains by substring match on the joint names (stiff
    # legs, soft arms: a scalar kp = 8000 on a 0.01 kg m^2 elbow rings at
    # the Nyquist rate of a 4 ms step); one robot per scenario
    (_, jmap), = info["jmap"].items()
    kp, kd = np.zeros(6 + len(jmap)), np.zeros(6 + len(jmap))
    for grp in pd["groups"]:
      for jname, dof in jmap.items():
        if grp["match"] in jname:
          kp[dof], kd[dof] = float(grp["kp"]), float(grp["kd"])
    info["pd_gains"] = tuple(torch.as_tensor(x, dtype=dtype, device=world.device)
                             for x in (kp, kd))
  elif pd:
    info["pd_gains"] = (float(pd["kp"]), float(pd["kd"]))
  else:
    info["pd_gains"] = None
  return world, info


def build_scene(cfg: dict, dtype=torch.float32, joint_limits: bool = True, device=None):
  """`build_world` + compile + PD gains -> (scene, info)."""
  world, info = build_world(cfg, dtype=dtype, device=device)
  scene = world.compile(joint_limits=joint_limits)
  if info["pd_gains"]:
    scene = scene.set_pd_gains(*info["pd_gains"])
  return scene, info
