"""The ANYmal-class quadruped from its URDF text to model tables (numpy, float64).

A frozen copy of the system's URDF generator, URDF parser and model builder,
cut to what the two benchmark configurations use: a floating base, revolute
joints, fixed joints collapsed into their parents, and sphere and box
collision geoms. The reference builds its own model from the configuration;
it takes nothing the system under test built.
"""

from __future__ import annotations

import dataclasses
import xml.etree.ElementTree as ET

import numpy as np

FREE, REVOLUTE = 0, 1
GEOM_SPHERE, GEOM_BOX = 0, 1

LEGS = [("LF", 1, 1), ("RF", 1, -1), ("LH", -1, 1), ("RH", -1, -1)]
BASE_SIZE = (0.53, 0.30, 0.24)
BASE_MASS = 19.0
HIP_MASS = 1.42
THIGH_MASS = 1.63
SHANK_MASS = 0.32
FOOT_MASS = 0.1
THIGH_LEN = 0.25
SHANK_LEN = 0.33
FOOT_RADIUS = 0.03
HAA_POS = (0.30, 0.15)
HFE_OFFSET = (0.06, 0.095)
MAX_TORQUE = 40.0
STAND_HFE = 0.4
STAND_KFE = -0.8


def _inertia_str(I):
  return (f'ixx="{I[0,0]:.6g}" iyy="{I[1,1]:.6g}" izz="{I[2,2]:.6g}" '
          f'ixy="{I[0,1]:.6g}" ixz="{I[0,2]:.6g}" iyz="{I[1,2]:.6g}"')


def _box_inertia(m, sx, sy, sz):
  return m / 12.0 * np.diag([sy * sy + sz * sz, sx * sx + sz * sz, sx * sx + sy * sy])


def _rod_inertia_z(m, l, r=0.03):
  i = m * (3 * r * r + l * l) / 12.0
  return np.diag([i, i, 0.5 * m * r * r])


def anymal_urdf() -> str:
  """The quadruped's URDF text: a box base, four legs of three revolute
  joints, a sphere foot on a fixed joint at each shank's end."""
  bx, by, bz = BASE_SIZE
  parts = [
      '<robot name="anymal">', '<link name="world"/>',
      '<joint name="root" type="floating"><parent link="world"/><child link="base"/></joint>',
      f'''<link name="base">
  <inertial><origin xyz="0 0 0"/><mass value="{BASE_MASS}"/>
    <inertia {_inertia_str(_box_inertia(BASE_MASS, bx, by, bz))}/></inertial>
  <collision><origin xyz="0 0 0"/><geometry><box size="{bx} {by} {bz}"/></geometry></collision>
</link>''']
  for name, sx, sy in LEGS:
    hip_I = np.diag([2e-3, 2e-3, 2e-3])
    thigh_I = _rod_inertia_z(THIGH_MASS, THIGH_LEN)
    shank_I = _rod_inertia_z(SHANK_MASS, SHANK_LEN)
    parts.append(f'''<link name="{name}_hip">
  <inertial><origin xyz="{0.03*sx} {0.02*sy} 0"/><mass value="{HIP_MASS}"/>
    <inertia {_inertia_str(hip_I)}/></inertial>
</link>
<joint name="{name}_HAA" type="revolute">
  <parent link="base"/><child link="{name}_hip"/>
  <origin xyz="{HAA_POS[0] * sx} {HAA_POS[1] * sy} 0"/><axis xyz="1 0 0"/>
  <limit effort="{MAX_TORQUE}" lower="-0.8" upper="0.8" velocity="15"/>
</joint>
<link name="{name}_thigh">
  <inertial><origin xyz="0 0 {-THIGH_LEN/2}"/><mass value="{THIGH_MASS}"/>
    <inertia {_inertia_str(thigh_I)}/></inertial>
</link>
<joint name="{name}_HFE" type="revolute">
  <parent link="{name}_hip"/><child link="{name}_thigh"/>
  <origin xyz="{HFE_OFFSET[0] * sx} {HFE_OFFSET[1] * sy} 0"/><axis xyz="0 1 0"/>
  <limit effort="{MAX_TORQUE}" lower="-6.28" upper="6.28" velocity="15"/>
</joint>
<link name="{name}_shank">
  <inertial><origin xyz="0 0 {-SHANK_LEN/2}"/><mass value="{SHANK_MASS}"/>
    <inertia {_inertia_str(shank_I)}/></inertial>
</link>
<joint name="{name}_KFE" type="revolute">
  <parent link="{name}_thigh"/><child link="{name}_shank"/>
  <origin xyz="0 0 {-THIGH_LEN}"/><axis xyz="0 1 0"/>
  <limit effort="{MAX_TORQUE}" lower="-6.28" upper="6.28" velocity="15"/>
</joint>
<link name="{name}_foot">
  <inertial><origin xyz="0 0 0"/><mass value="{FOOT_MASS}"/>
    <inertia ixx="4e-5" iyy="4e-5" izz="4e-5" ixy="0" ixz="0" iyz="0"/></inertial>
  <collision><origin xyz="0 0 0"/><geometry><sphere radius="{FOOT_RADIUS}"/></geometry></collision>
</link>
<joint name="{name}_foot_joint" type="fixed">
  <parent link="{name}_shank"/><child link="{name}_foot"/>
  <origin xyz="0 0 {-SHANK_LEN}"/>
</joint>''')
  parts.append("</robot>")
  return "\n".join(parts)


def standing_q() -> np.ndarray:
  """[base position, quaternion wxyz, 12 joint angles] of the nominal stance,
  the feet on the ground at z = 0."""
  drop = THIGH_LEN * np.cos(STAND_HFE) + SHANK_LEN * np.cos(STAND_HFE + STAND_KFE)
  q = [0.0, 0.0, drop + FOOT_RADIUS, 1.0, 0.0, 0.0, 0.0]
  for _, sx, _ in LEGS:
    q += [0.0, STAND_HFE * sx, STAND_KFE * sx]
  return np.asarray(q)


def _rpy(rpy) -> np.ndarray:
  r, p, y = rpy
  cr, sr, cp, sp, cy, sy = np.cos(r), np.sin(r), np.cos(p), np.sin(p), np.cos(y), np.sin(y)
  return (np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
          @ np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
          @ np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]]))


def _origin(el):
  if el is None:
    return np.zeros(3), np.eye(3)
  return (np.array([float(v) for v in el.get("xyz", "0 0 0").split()]),
          _rpy([float(v) for v in el.get("rpy", "0 0 0").split()]))


class _Link:
  def __init__(self, name, mass, com, inertia):
    self.name, self.mass, self.com, self.inertia = name, mass, com, inertia
    self.geoms = []

  def absorb(self, mass, com, inertia):
    """Add a rigid component (parallel-axis theorem, link frame)."""
    m = self.mass + mass
    c = (self.mass * self.com + mass * com) / m

    def shift(I, mi, ci):
      d = ci - c
      return I + mi * ((d @ d) * np.eye(3) - np.outer(d, d))

    self.inertia = shift(self.inertia, self.mass, self.com) + shift(inertia, mass, com)
    self.mass, self.com = m, c


def parse_urdf(text: str):
  """(bodies, geoms) of a floating-base URDF: bodies in depth-first order,
  each a dict (parent, joint, axis, pos, rot, mass, com, inertia, torque
  limit, q_lo, q_hi); geoms (body, gtype, params, offset_pos, offset_rot)."""
  root = ET.fromstring(text)
  links = {}
  for lel in root.findall("link"):
    iel = lel.find("inertial")
    if iel is None:
      mass, com, inertia = 0.0, np.zeros(3), np.zeros((3, 3))
    else:
      com, R = _origin(iel.find("origin"))
      mass = float(iel.find("mass").get("value"))
      ie = iel.find("inertia")
      xx, yy, zz = (float(ie.get(k)) for k in ("ixx", "iyy", "izz"))
      xy, xz, yz = (float(ie.get(k, 0)) for k in ("ixy", "ixz", "iyz"))
      inertia = R @ np.array([[xx, xy, xz], [xy, yy, yz], [xz, yz, zz]]) @ R.T
    link = _Link(lel.get("name"), mass, com, inertia)
    for cel in lel.findall("collision"):
      pos, R = _origin(cel.find("origin"))
      geo = cel.find("geometry")
      if geo.find("sphere") is not None:
        link.geoms.append((GEOM_SPHERE, [float(geo.find("sphere").get("radius"))], pos, R))
      elif geo.find("box") is not None:
        size = [float(v) for v in geo.find("box").get("size").split()]
        link.geoms.append((GEOM_BOX, [s / 2 for s in size], pos, R))
      else:
        raise ValueError(f"link {link.name}: only sphere and box collision geoms")
    links[link.name] = link

  joints = []
  for jel in root.findall("joint"):
    pos, R = _origin(jel.find("origin"))
    ax = jel.find("axis")
    lim = jel.find("limit")
    joints.append(dict(
        name=jel.get("name"), type=jel.get("type"), parent=jel.find("parent").get("link"),
        child=jel.find("child").get("link"), pos=pos, rot=R,
        axis=(np.array([float(v) for v in ax.get("xyz").split()]) if ax is not None
              else np.array([1.0, 0.0, 0.0])),
        effort=float(lim.get("effort", 1e9)) if lim is not None else 1e9,
        lo=float(lim.get("lower", 0.0)) if lim is not None else -1e9,
        hi=float(lim.get("upper", 0.0)) if lim is not None else 1e9))

  # the massless world link and its floating joint make the base a free body
  floating = [j for j in joints if j["type"] == "floating"]
  if len(floating) != 1:
    raise ValueError("expected one floating joint from the world link")
  joints.remove(floating[0])
  del links[floating[0]["parent"]]
  base = floating[0]["child"]

  # fixed joints fold the child link into its parent
  for j in [j for j in joints if j["type"] == "fixed"]:
    p, c = links[j["parent"]], links[j["child"]]
    T, Rt = j["pos"], j["rot"]
    p.absorb(c.mass, T + Rt @ c.com, Rt @ c.inertia @ Rt.T)
    for gt, prm, gp, gR in c.geoms:
      p.geoms.append((gt, prm, T + Rt @ gp, Rt @ gR))
    for j2 in joints:
      if j2["parent"] == j["child"]:
        j2.update(parent=j["parent"], pos=T + Rt @ j2["pos"], rot=Rt @ j2["rot"])
    joints.remove(j)
    del links[j["child"]]

  bodies, geoms = [], []

  def emit(name, parent, joint):
    link = links[name]
    idx = len(bodies)
    body = dict(parent=parent, mass=max(link.mass, 1e-9), com=link.com,
                inertia=link.inertia)
    if joint is None:
      body.update(joint=FREE, axis=np.array([0.0, 0.0, 1.0]), pos=np.zeros(3), rot=np.eye(3),
                  torque_limit=1e9, lo=-1e9, hi=1e9)
    else:
      if joint["type"] not in ("revolute", "continuous"):
        raise ValueError(f"unsupported joint type {joint['type']}")
      lo, hi = ((-1e9, 1e9) if joint["type"] == "continuous" else (joint["lo"], joint["hi"]))
      body.update(joint=REVOLUTE, axis=joint["axis"], pos=joint["pos"], rot=joint["rot"],
                  torque_limit=joint["effort"], lo=lo, hi=hi)
    bodies.append(body)
    for gt, prm, gp, gR in link.geoms:
      geoms.append(dict(body=idx, gtype=gt, params=np.resize(np.asarray(prm, float), 4),
                        offset_pos=gp, offset_rot=gR))
    for j in joints:
      if j["parent"] == name:
        emit(j["child"], idx, j)

  emit(base, -1, None)
  return bodies, geoms


@dataclasses.dataclass(frozen=True)
class Model:
  """Model tables: static structure as tuples, numbers as float64 arrays."""

  parent: tuple
  joint: tuple
  q_adr: tuple
  v_adr: tuple
  nq: int
  nv: int
  X_rot: np.ndarray      # (nb, 3, 3) parent -> joint frame at q = 0
  X_pos: np.ndarray      # (nb, 3)
  axis: np.ndarray       # (nb, 3)
  inertia: np.ndarray    # (nb, 6, 6) spatial inertia about the body origin
  actuated: np.ndarray   # (nv,)
  torque_limit: np.ndarray
  joint_lo: np.ndarray
  joint_hi: np.ndarray

  @property
  def nb(self) -> int:
    return len(self.parent)

  def ancestor_mask(self) -> np.ndarray:
    """(nb, nv): 1 where the dof moves the body (its joint is an ancestor)."""
    m = np.zeros((self.nb, self.nv))
    for b in range(self.nb):
      k = b
      while k >= 0:
        n = 6 if self.joint[k] == FREE else 1
        m[b, self.v_adr[k]:self.v_adr[k] + n] = 1.0
        k = self.parent[k]
    return m


def build_model(bodies) -> Model:
  parent, joint, q_adr, v_adr = [], [], [], []
  nq = nv = 0
  nb = len(bodies)
  X_rot, X_pos, axis = np.zeros((nb, 3, 3)), np.zeros((nb, 3)), np.zeros((nb, 3))
  inertia = np.zeros((nb, 6, 6))
  act, tlim, lo, hi = [], [], [], []
  for i, b in enumerate(bodies):
    parent.append(b["parent"])
    joint.append(b["joint"])
    q_adr.append(nq)
    v_adr.append(nv)
    n = 6 if b["joint"] == FREE else 1
    nq += 7 if b["joint"] == FREE else 1
    nv += n
    X_rot[i], X_pos[i] = b["rot"], b["pos"]
    axis[i] = b["axis"] / max(np.linalg.norm(b["axis"]), 1e-12)
    m, c = b["mass"], np.asarray(b["com"], float)
    C = np.array([[0, -c[2], c[1]], [c[2], 0, -c[0]], [-c[1], c[0], 0]])
    inertia[i] = np.block([[b["inertia"] + m * (C @ C.T), m * C], [m * C.T, m * np.eye(3)]])
    act += [0.0 if b["joint"] == FREE else 1.0] * n
    tlim += [b["torque_limit"]] * n
    lo += [b["lo"]] * n
    hi += [b["hi"]] * n
  return Model(tuple(parent), tuple(joint), tuple(q_adr), tuple(v_adr), nq, nv, X_rot, X_pos,
               axis, inertia, np.array(act), np.array(tlim), np.array(lo), np.array(hi))
