"""Atlas-class 23-DoF humanoid (BASELINE config 5: Atlas + 1024-robot batched scene).

A copy of raisimlib_tpu/models/atlas.py (numpy only), kept here so that the
port imports nothing of the JAX package. Emitted as a URDF string through the
same parser path as the quadruped (models/anymal.py). Dimensions and masses
are representative of a DRC-Atlas-class machine (~150 kg, 0.42 m thigh and
shin): FREE pelvis + 3 back joints + 2 legs x 6 (hip yaw/roll/pitch, knee,
ankle pitch/roll) + 2 arms x 4 (shoulder z/x, elbow y/x), nq = 30, nv = 29.
The pelvis, the torso and the two feet carry box collision geoms: against
the ground plane that is 8 corner slots each, 32 `plane_pt` contact slots in
all (the JAX module's docstring counts only the feet's 16), plus 23
joint-limit rows.
"""

from __future__ import annotations

import numpy as np

PELVIS_MASS = 18.0
TORSO_MASS = 50.0
UGLUT_MASS = 2.0      # per back segment
THIGH_MASS = 9.0
SHIN_MASS = 5.0
FOOT_MASS = 2.4
UARM_MASS = 4.0
LARM_MASS = 3.0

THIGH_LEN = 0.42
SHIN_LEN = 0.42
ANKLE_DROP = 0.08     # ankle joint to sole
HIP_Y = 0.089         # pelvis center to hip, lateral
FOOT_HALF = (0.13, 0.065, 0.02)
FOOT_FWD = 0.04       # foot box center forward of ankle
UARM_LEN = 0.30
LARM_LEN = 0.30
SHOULDER_Y = 0.22
TORSO_LEN = 0.40

KNEE_BEND = 0.35      # standing posture
MAX_TORQUE = 300.0


def _inertia_str(I):
  return (f'ixx="{I[0,0]:.6g}" iyy="{I[1,1]:.6g}" izz="{I[2,2]:.6g}" '
          f'ixy="{I[0,1]:.6g}" ixz="{I[0,2]:.6g}" iyz="{I[1,2]:.6g}"')


def _box_inertia(m, sx, sy, sz):
  return m / 12.0 * np.diag([sy * sy + sz * sz, sx * sx + sz * sz, sx * sx + sy * sy])


def _rod_inertia_z(m, l, r=0.06):
  i = m * (3 * r * r + l * l) / 12.0
  return np.diag([i, i, 0.5 * m * r * r])


def _link(name, mass, inertia, com=(0, 0, 0), collision=None):
  col = ""
  if collision is not None:
    geom, origin = collision
    col = (f'\n  <collision><origin xyz="{origin[0]} {origin[1]} {origin[2]}"/>'
           f'\n    <geometry>{geom}</geometry></collision>')
  return (f'<link name="{name}">\n'
          f'  <inertial><origin xyz="{com[0]} {com[1]} {com[2]}"/>'
          f'<mass value="{mass}"/>\n'
          f'    <inertia {_inertia_str(inertia)}/></inertial>{col}\n</link>')


def _joint(name, parent, child, xyz, axis, lo, hi, effort=MAX_TORQUE):
  return (f'<joint name="{name}" type="revolute">\n'
          f'  <parent link="{parent}"/><child link="{child}"/>\n'
          f'  <origin xyz="{xyz[0]} {xyz[1]} {xyz[2]}"/>'
          f'<axis xyz="{axis[0]} {axis[1]} {axis[2]}"/>\n'
          f'  <limit effort="{effort}" lower="{lo}" upper="{hi}" velocity="12"/>\n'
          f'</joint>')


def atlas_urdf() -> str:
  p = [
      '<robot name="atlas_tpu">',
      '<link name="world"/>',
      '<joint name="root" type="floating">\n'
      '  <parent link="world"/><child link="pelvis"/>\n</joint>',
      _link("pelvis", PELVIS_MASS, _box_inertia(PELVIS_MASS, 0.25, 0.3, 0.2),
            collision=('<box size="0.25 0.3 0.2"/>', (0, 0, 0))),
      # --- back: z, y, x serial chain to the torso ---
      _link("ltorso", UGLUT_MASS, np.diag([0.01, 0.01, 0.01])),
      _joint("back_bkz", "pelvis", "ltorso", (-0.01, 0, 0.09),
             (0, 0, 1), -0.66, 0.66),
      _link("mtorso", UGLUT_MASS, np.diag([0.01, 0.01, 0.01])),
      _joint("back_bky", "ltorso", "mtorso", (0, 0, 0.09), (0, 1, 0),
             -0.22, 0.54),
      _link("utorso", TORSO_MASS,
            _box_inertia(TORSO_MASS, 0.3, 0.35, TORSO_LEN), com=(0, 0, 0.2),
            collision=(f'<box size="0.3 0.35 {TORSO_LEN}"/>', (0, 0, 0.2))),
      _joint("back_bkx", "mtorso", "utorso", (0, 0, 0.05), (1, 0, 0),
             -0.52, 0.52),
  ]

  for side, sy in (("l", 1), ("r", -1)):
    # --- leg: hpz, hpx, hpy, kny, aky, akx ---
    p += [
        _link(f"{side}_uglut", UGLUT_MASS, np.diag([5e-3, 5e-3, 5e-3])),
        _joint(f"{side}_leg_hpz", "pelvis", f"{side}_uglut",
               (0, HIP_Y * sy, -0.09), (0, 0, 1), -0.78, 0.78),
        _link(f"{side}_lglut", UGLUT_MASS, np.diag([5e-3, 5e-3, 5e-3])),
        _joint(f"{side}_leg_hpx", f"{side}_uglut", f"{side}_lglut",
               (0, 0, 0), (1, 0, 0), -0.52, 0.52),
        _link(f"{side}_uleg", THIGH_MASS, _rod_inertia_z(THIGH_MASS, THIGH_LEN),
              com=(0, 0, -THIGH_LEN / 2)),
        _joint(f"{side}_leg_hpy", f"{side}_lglut", f"{side}_uleg",
               (0.05, 0, -0.05), (0, 1, 0), -1.61, 0.65),
        _link(f"{side}_lleg", SHIN_MASS, _rod_inertia_z(SHIN_MASS, SHIN_LEN),
              com=(0, 0, -SHIN_LEN / 2)),
        _joint(f"{side}_leg_kny", f"{side}_uleg", f"{side}_lleg",
               (0, 0, -THIGH_LEN), (0, 1, 0), 0.0, 2.35),
        _link(f"{side}_talus", 0.2, np.diag([1e-3, 1e-3, 1e-3])),
        _joint(f"{side}_leg_aky", f"{side}_lleg", f"{side}_talus",
               (0, 0, -SHIN_LEN), (0, 1, 0), -1.0, 0.7),
        _link(f"{side}_foot", FOOT_MASS,
              _box_inertia(FOOT_MASS, 2 * FOOT_HALF[0], 2 * FOOT_HALF[1],
                           2 * FOOT_HALF[2]),
              com=(FOOT_FWD, 0, -ANKLE_DROP + FOOT_HALF[2]),
              collision=(
                  f'<box size="{2*FOOT_HALF[0]} {2*FOOT_HALF[1]} {2*FOOT_HALF[2]}"/>',
                  (FOOT_FWD, 0, -ANKLE_DROP + FOOT_HALF[2]))),
        _joint(f"{side}_leg_akx", f"{side}_talus", f"{side}_foot",
               (0, 0, 0), (1, 0, 0), -0.8, 0.8),
    ]
    # --- arm: shz, shx, ely, elx (mass kept, no collision geoms) ---
    p += [
        _link(f"{side}_clav", 1.0, np.diag([5e-3, 5e-3, 5e-3])),
        _joint(f"{side}_arm_shz", "utorso", f"{side}_clav",
               (0.05, SHOULDER_Y * sy, 0.35), (0, 0, 1), -1.57, 1.57),
        _link(f"{side}_uarm", UARM_MASS, _rod_inertia_z(UARM_MASS, UARM_LEN),
              com=(0, 0, -UARM_LEN / 2)),
        _joint(f"{side}_arm_shx", f"{side}_clav", f"{side}_uarm",
               (0, 0.05 * sy, 0), (1, 0, 0), -1.57, 1.57),
        _link(f"{side}_larm", LARM_MASS, _rod_inertia_z(LARM_MASS, LARM_LEN),
              com=(0, 0, -LARM_LEN / 2)),
        _joint(f"{side}_arm_ely", f"{side}_uarm", f"{side}_larm",
               (0, 0, -UARM_LEN), (0, 1, 0), 0.0, 2.35),
        _link(f"{side}_hand", 0.5, np.diag([1e-3, 1e-3, 1e-3])),
        _joint(f"{side}_arm_elx", f"{side}_larm", f"{side}_hand",
               (0, 0, -LARM_LEN), (1, 0, 0), -1.57, 1.57),
    ]
  p.append("</robot>")
  return "\n".join(p)


JOINT_ORDER = (
    ["back_bkz", "back_bky", "back_bkx"]
    + [f"{s}_leg_{j}" for s in ("l", "r")
       for j in ("hpz", "hpx", "hpy", "kny", "aky", "akx")]
    + [f"{s}_arm_{j}" for s in ("l", "r") for j in ("shz", "shx", "ely", "elx")]
)


def standing_q(jmap: dict | None = None, base_z: float | None = None) -> np.ndarray:
  """gc for a slight-knee-bend stance: [pos(3), quat(4), 23 joint angles].

  Joint angles are placed by NAME through the parser's dof map (`jmap`, as
  returned by `load_urdf(atlas_urdf())`), so the stance is independent of the
  parser's traversal order. Passing jmap=None parses once internally.
  """
  if jmap is None:
    from raisimlib_torch.models.urdf import load_urdf

    _, _, jmap = load_urdf(atlas_urdf())
  hpy = -KNEE_BEND / 2
  kny = KNEE_BEND
  aky = -KNEE_BEND / 2
  if base_z is None:
    # pelvis height: hip drop 0.14 + thigh + shin (with bend) + ankle drop
    drop = (0.14 + THIGH_LEN * np.cos(hpy)
            + SHIN_LEN * np.cos(hpy + kny) + ANKLE_DROP)
    base_z = drop + 0.001
  angles = {}
  for side in ("l", "r"):
    angles[f"{side}_leg_hpy"] = hpy
    angles[f"{side}_leg_kny"] = kny
    angles[f"{side}_leg_aky"] = aky
    angles[f"{side}_arm_ely"] = 0.5        # slight elbow bend
    angles[f"{side}_arm_shx"] = 0.0
  q = np.zeros(7 + len(jmap))
  q[2] = base_z
  q[3] = 1.0
  for name, dof in jmap.items():
    # 1-dof joints after a FREE root: q index = dof index + 1
    q[dof + 1] = angles.get(name, 0.0)
  return q
