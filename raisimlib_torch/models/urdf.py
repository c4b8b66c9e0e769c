"""URDF parser -> build_model body specs + collision geom specs.

Counterpart of raisimlib_tpu/models/urdf.py. Supported: revolute/continuous/
prismatic/fixed/floating joints, inertial origins with rpy, sphere/box/
cylinder/capsule collision geoms. Fixed joints are collapsed into the parent
(inertia composed by the parallel-axis theorem, geoms re-expressed in the
parent frame). Mesh collision geometry (OBJ/STL) is not ported yet and raises.
"""

from __future__ import annotations

import warnings
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple

import numpy as np

from raisimlib_torch.models.model import JointType, joint_nv
from raisimlib_torch.ops.collision import (
    GEOM_BOX,
    GEOM_CAPSULE,
    GEOM_CYLINDER,
    GEOM_SPHERE,
)


def _rpy_to_mat(rpy) -> np.ndarray:
  r, p, y = rpy
  cr, sr = np.cos(r), np.sin(r)
  cp, sp = np.cos(p), np.sin(p)
  cy, sy = np.cos(y), np.sin(y)
  Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
  Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
  Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
  return Rz @ Ry @ Rx


def _parse_origin(el) -> Tuple[np.ndarray, np.ndarray]:
  if el is None:
    return np.zeros(3), np.eye(3)
  xyz = np.array([float(v) for v in el.get("xyz", "0 0 0").split()])
  rpy = [float(v) for v in el.get("rpy", "0 0 0").split()]
  return xyz, _rpy_to_mat(rpy)


class _Link:
  def __init__(self, name):
    self.name = name
    self.mass = 0.0
    self.com = np.zeros(3)
    self.inertia = np.zeros((3, 3))  # about com, link-frame axes
    self.geoms: List[dict] = []

  def add_inertial(self, mass, com, inertia):
    """Combine another rigid component (parallel-axis in link frame)."""
    if mass <= 0.0 and self.mass <= 0.0:
      return
    m_tot = self.mass + mass
    com_tot = (self.mass * self.com + mass * com) / m_tot

    def shift(I, m, c, c_new):
      d = c - c_new
      return I + m * ((d @ d) * np.eye(3) - np.outer(d, d))

    self.inertia = shift(self.inertia, self.mass, self.com, com_tot) + shift(
        inertia, mass, com, com_tot)
    self.mass = m_tot
    self.com = com_tot


def _parse_inertial(el) -> Tuple[float, np.ndarray, np.ndarray]:
  if el is None:
    return 0.0, np.zeros(3), np.zeros((3, 3))
  pos, R = _parse_origin(el.find("origin"))
  mass = float(el.find("mass").get("value"))
  ie = el.find("inertia")
  ixx, iyy, izz = (float(ie.get(k)) for k in ("ixx", "iyy", "izz"))
  ixy, ixz, iyz = (float(ie.get(k, 0)) for k in ("ixy", "ixz", "iyz"))
  I = np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])
  return mass, pos, R @ I @ R.T


def _parse_geometry(geo_el, pos, R, material) -> Optional[dict]:
  sphere = geo_el.find("sphere")
  if sphere is not None:
    return dict(gtype=GEOM_SPHERE, params=[float(sphere.get("radius"))],
                offset_pos=pos, offset_rot=R, material=material)
  box = geo_el.find("box")
  if box is not None:
    size = [float(v) for v in box.get("size").split()]
    return dict(gtype=GEOM_BOX, params=[s / 2 for s in size], offset_pos=pos,
                offset_rot=R, material=material)
  cyl = geo_el.find("cylinder")
  if cyl is not None:
    return dict(gtype=GEOM_CYLINDER,
                params=[float(cyl.get("radius")), float(cyl.get("length")) / 2],
                offset_pos=pos, offset_rot=R, material=material)
  cap = geo_el.find("capsule")
  if cap is not None:
    return dict(gtype=GEOM_CAPSULE,
                params=[float(cap.get("radius")), float(cap.get("length")) / 2],
                offset_pos=pos, offset_rot=R, material=material)
  if geo_el.find("mesh") is not None:
    raise NotImplementedError(
        "URDF mesh collision geometry (OBJ/STL) is not ported to "
        "raisimlib_torch yet: ROADMAP.md, 'Rest of collision and constraints'")
  return None


def load_urdf(
    path_or_string: str,
    floating_base: bool = True,
    material: int = 0,
    collapse_fixed: bool = True,
) -> Tuple[List[dict], List[dict], Dict[str, int]]:
  """Parse URDF into (body_specs, geom_specs, joint_name_to_dof) for World."""
  if path_or_string.lstrip().startswith("<"):
    root = ET.fromstring(path_or_string)
  else:
    root = ET.parse(path_or_string).getroot()

  links: Dict[str, _Link] = {}
  for lel in root.findall("link"):
    link = _Link(lel.get("name"))
    link.mass, link.com, link.inertia = _parse_inertial(lel.find("inertial"))
    for cel in lel.findall("collision"):
      pos, R = _parse_origin(cel.find("origin"))
      g = _parse_geometry(cel.find("geometry"), pos, R, material)
      if g is None:
        warnings.warn(f"unsupported collision geometry on link {link.name}; skipped")
      else:
        link.geoms.append(g)
    links[link.name] = link

  joints = []
  child_of = {}
  for jel in root.findall("joint"):
    jtype = jel.get("type")
    pos, R = _parse_origin(jel.find("origin"))
    axis_el = jel.find("axis")
    axis = (np.array([float(v) for v in axis_el.get("xyz").split()])
            if axis_el is not None else np.array([1.0, 0.0, 0.0]))
    limit_el = jel.find("limit")
    effort = float(limit_el.get("effort", 1e9)) if limit_el is not None else 1e9
    # URDF: with a <limit>, missing lower/upper default to 0; none = unlimited
    q_lo = float(limit_el.get("lower", 0.0)) if limit_el is not None else -1e9
    q_hi = float(limit_el.get("upper", 0.0)) if limit_el is not None else 1e9
    if jtype == "continuous":
      q_lo, q_hi = -1e9, 1e9
    joints.append(dict(name=jel.get("name"), type=jtype,
                       parent=jel.find("parent").get("link"),
                       child=jel.find("child").get("link"),
                       pos=pos, rot=R, axis=axis, effort=effort,
                       q_lo=q_lo, q_hi=q_hi))
    child_of[joints[-1]["child"]] = joints[-1]

  roots = [n for n in links if n not in child_of]
  if len(roots) != 1:
    raise ValueError(f"URDF must have exactly one root link, got {roots}")
  root_link = roots[0]

  # explicit floating-base pattern: massless "world" root + one floating joint
  rl = links[root_link]
  root_joints = [j for j in joints if j["parent"] == root_link]
  if (rl.mass == 0.0 and not rl.geoms and len(root_joints) == 1
      and root_joints[0]["type"] == "floating"):
    joints.remove(root_joints[0])
    del links[root_link]
    root_link = root_joints[0]["child"]
    floating_base = True

  if collapse_fixed:
    changed = True
    while changed:
      changed = False
      for j in list(joints):
        if j["type"] != "fixed":
          continue
        p, c = j["parent"], j["child"]
        plink, clink = links[p], links[c]
        T_pos, T_rot = j["pos"], j["rot"]
        plink.add_inertial(clink.mass, T_pos + T_rot @ clink.com,
                           T_rot @ clink.inertia @ T_rot.T)
        for g in clink.geoms:
          plink.geoms.append(
              dict(g, offset_pos=T_pos + T_rot @ np.asarray(g["offset_pos"]),
                   offset_rot=T_rot @ np.asarray(g["offset_rot"])))
        for j2 in joints:
          if j2["parent"] == c:
            j2["parent"] = p
            j2["pos"] = T_pos + T_rot @ j2["pos"]
            j2["rot"] = T_rot @ j2["rot"]
        joints.remove(j)
        del links[c]
        changed = True

  body_specs: List[dict] = []
  geom_specs: List[dict] = []
  body_index: Dict[str, int] = {}
  joint_to_dof: Dict[str, int] = {}
  type_map = {"revolute": JointType.REVOLUTE, "continuous": JointType.REVOLUTE,
              "prismatic": JointType.PRISMATIC,
              "spherical": JointType.SPHERICAL, "ball": JointType.SPHERICAL}

  def emit(link_name: str, parent_idx: int, joint: Optional[dict]):
    link = links[link_name]
    if joint is None:
      if not floating_base:
        raise ValueError("fixed-base URDF requires at least one moving joint at root")
      spec = dict(parent=-1, joint=JointType.FREE, mass=max(link.mass, 1e-9),
                  com=link.com, inertia=link.inertia, actuated=False,
                  name=link_name)
    else:
      jt = type_map.get(joint["type"])
      if jt is None:
        raise ValueError(f"unsupported joint type {joint['type']}")
      spec = dict(parent=parent_idx, joint=jt, axis=joint["axis"], pos=joint["pos"],
                  rot=joint["rot"], mass=max(link.mass, 1e-9), com=link.com,
                  inertia=link.inertia, actuated=True, torque_limit=joint["effort"],
                  q_lo=joint.get("q_lo", -1e9), q_hi=joint.get("q_hi", 1e9),
                  name=link_name)
    idx = len(body_specs)
    body_specs.append(spec)
    body_index[link_name] = idx
    for g in link.geoms:
      geom_specs.append(dict(g, body=idx))
    for j in joints:
      if j["parent"] == link_name:
        emit(j["child"], idx, j)

  emit(root_link, -1, None)

  nv = 0
  for i, spec in enumerate(body_specs):
    for j in joints:
      if body_index.get(j["child"]) == i:
        joint_to_dof[j["name"]] = nv
    nv += joint_nv(spec["joint"])
  return body_specs, geom_specs, joint_to_dof
