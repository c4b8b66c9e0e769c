"""ANYmal-class 12-DoF quadruped, emitted as a URDF string.

A copy of raisimlib_tpu/models/anymal.py (numpy only), kept here so that the
port imports nothing of the JAX package. The robot is loaded through the URDF
parser, the same path a user's robot takes; feet are fixed links with sphere
collision geoms, collapsed into the shank by the parser.
"""

from __future__ import annotations

import numpy as np

LEGS = [("LF", 1, 1), ("RF", 1, -1), ("LH", -1, 1), ("RH", -1, -1)]

# geometry (m) / masses (kg)
BASE_SIZE = (0.53, 0.30, 0.24)
BASE_MASS = 19.0
HIP_MASS = 1.42
THIGH_MASS = 1.63
SHANK_MASS = 0.32
FOOT_MASS = 0.1
THIGH_LEN = 0.25
SHANK_LEN = 0.33
FOOT_RADIUS = 0.03
HAA_POS = (0.30, 0.15)      # x, |y| of HAA joint on base
HFE_OFFSET = (0.06, 0.095)  # x, |y| offset hip -> HFE
MAX_TORQUE = 40.0

# standing configuration (HAA, HFE, KFE) per leg; X-configuration knees
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
  """Generate the quadruped URDF."""
  bx, by, bz = BASE_SIZE
  parts = [
      '<robot name="anymal_tpu">',
      '<link name="world"/>',
      '<joint name="root" type="floating">\n'
      '  <parent link="world"/><child link="base"/>\n</joint>',
      f'''<link name="base">
  <inertial><origin xyz="0 0 0"/><mass value="{BASE_MASS}"/>
    <inertia {_inertia_str(_box_inertia(BASE_MASS, bx, by, bz))}/></inertial>
  <collision><origin xyz="0 0 0"/>
    <geometry><box size="{bx} {by} {bz}"/></geometry></collision>
</link>''',
  ]
  for name, sx, sy in LEGS:
    haa_x, haa_y = HAA_POS[0] * sx, HAA_POS[1] * sy
    hfe_x, hfe_y = HFE_OFFSET[0] * sx, HFE_OFFSET[1] * sy
    hip_I = np.diag([2e-3, 2e-3, 2e-3])
    thigh_I = _rod_inertia_z(THIGH_MASS, THIGH_LEN)
    shank_I = _rod_inertia_z(SHANK_MASS, SHANK_LEN)
    parts.append(f'''<link name="{name}_hip">
  <inertial><origin xyz="{0.03*sx} {0.02*sy} 0"/><mass value="{HIP_MASS}"/>
    <inertia {_inertia_str(hip_I)}/></inertial>
</link>
<joint name="{name}_HAA" type="revolute">
  <parent link="base"/><child link="{name}_hip"/>
  <origin xyz="{haa_x} {haa_y} 0"/><axis xyz="1 0 0"/>
  <limit effort="{MAX_TORQUE}" lower="-0.8" upper="0.8" velocity="15"/>
</joint>
<link name="{name}_thigh">
  <inertial><origin xyz="0 0 {-THIGH_LEN/2}"/><mass value="{THIGH_MASS}"/>
    <inertia {_inertia_str(thigh_I)}/></inertial>
</link>
<joint name="{name}_HFE" type="revolute">
  <parent link="{name}_hip"/><child link="{name}_thigh"/>
  <origin xyz="{hfe_x} {hfe_y} 0"/><axis xyz="0 1 0"/>
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
  <collision><origin xyz="0 0 0"/>
    <geometry><sphere radius="{FOOT_RADIUS}"/></geometry></collision>
</link>
<joint name="{name}_foot_joint" type="fixed">
  <parent link="{name}_shank"/><child link="{name}_foot"/>
  <origin xyz="0 0 {-SHANK_LEN}"/>
</joint>''')
  parts.append("</robot>")
  return "\n".join(parts)


def standing_q(base_z: float | None = None) -> np.ndarray:
  """gc for the nominal stance: [pos(3), quat wxyz(4), 12 joint angles]."""
  if base_z is None:
    drop = THIGH_LEN * np.cos(STAND_HFE) + SHANK_LEN * np.cos(STAND_HFE + STAND_KFE)
    base_z = drop + FOOT_RADIUS
  q = [0.0, 0.0, base_z, 1.0, 0.0, 0.0, 0.0]
  for name, sx, sy in LEGS:
    q += [0.0, STAND_HFE * sx, STAND_KFE * sx]
  return np.asarray(q)


def joint_order():
  """The 12 actuated joint names in dof order (LF, RF, LH, RH; HAA, HFE, KFE)."""
  return [f"{name}_{j}" for name, _, _ in LEGS for j in ("HAA", "HFE", "KFE")]
