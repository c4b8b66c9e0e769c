"""The Atlas-class humanoid: its URDF text, stance and the scene it steps.

A frozen copy (numpy only) of the system's generated 23-dof humanoid:
a floating pelvis, a back of three revolute joints to the torso, two legs of
six (hip z, x, y, knee, ankle y, x) and two arms of four (shoulder z, x,
elbow y, x); nq 30, nv 29. The pelvis, the torso and both feet carry boxes,
8 corner slots each against the ground plane (32 slots), and every joint has
a limit row (23 rows). It is built with the reference's own URDF parser and
model builder (`model.parse_urdf`, `model.build_model`).

The step is `step.Scene.step_margin`'s, unchanged; only the scene differs:
the robot, and the PD gains, which the configuration gives per joint group
(`pd_gains.groups`: kp and kd on each joint whose name holds the group's
`match`, a later group overriding an earlier one), so that kp and the
damping D are (nv,) vectors rather than scalars times the actuated mask.
No departure from the system's step is known: it is checked against the
system's fused twin and its K2 path in float64 (portbench/tests).
"""

from __future__ import annotations

import xml.etree.ElementTree as ET

import numpy as np
import torch

from portbench.reference import collide, dynamics, model, step

PELVIS_MASS = 18.0
TORSO_MASS = 50.0
UGLUT_MASS = 2.0
THIGH_MASS = 9.0
SHIN_MASS = 5.0
FOOT_MASS = 2.4
UARM_MASS = 4.0
LARM_MASS = 3.0
THIGH_LEN = 0.42
SHIN_LEN = 0.42
ANKLE_DROP = 0.08
HIP_Y = 0.089
FOOT_HALF = (0.13, 0.065, 0.02)
FOOT_FWD = 0.04
UARM_LEN = 0.30
LARM_LEN = 0.30
SHOULDER_Y = 0.22
TORSO_LEN = 0.40
KNEE_BEND = 0.35
MAX_TORQUE = 300.0


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
          f'    <inertia {model._inertia_str(inertia)}/></inertial>{col}\n</link>')


def _joint(name, parent, child, xyz, axis, lo, hi, effort=MAX_TORQUE):
  return (f'<joint name="{name}" type="revolute">\n'
          f'  <parent link="{parent}"/><child link="{child}"/>\n'
          f'  <origin xyz="{xyz[0]} {xyz[1]} {xyz[2]}"/>'
          f'<axis xyz="{axis[0]} {axis[1]} {axis[2]}"/>\n'
          f'  <limit effort="{effort}" lower="{lo}" upper="{hi}" velocity="12"/>\n'
          f'</joint>')


def atlas_urdf() -> str:
  """The humanoid's URDF text."""
  box = model._box_inertia
  p = [
      '<robot name="atlas_tpu">',
      '<link name="world"/>',
      '<joint name="root" type="floating">\n'
      '  <parent link="world"/><child link="pelvis"/>\n</joint>',
      _link("pelvis", PELVIS_MASS, box(PELVIS_MASS, 0.25, 0.3, 0.2),
            collision=('<box size="0.25 0.3 0.2"/>', (0, 0, 0))),
      _link("ltorso", UGLUT_MASS, np.diag([0.01, 0.01, 0.01])),
      _joint("back_bkz", "pelvis", "ltorso", (-0.01, 0, 0.09), (0, 0, 1), -0.66, 0.66),
      _link("mtorso", UGLUT_MASS, np.diag([0.01, 0.01, 0.01])),
      _joint("back_bky", "ltorso", "mtorso", (0, 0, 0.09), (0, 1, 0), -0.22, 0.54),
      _link("utorso", TORSO_MASS, box(TORSO_MASS, 0.3, 0.35, TORSO_LEN), com=(0, 0, 0.2),
            collision=(f'<box size="0.3 0.35 {TORSO_LEN}"/>', (0, 0, 0.2))),
      _joint("back_bkx", "mtorso", "utorso", (0, 0, 0.05), (1, 0, 0), -0.52, 0.52),
  ]
  for side, sy in (("l", 1), ("r", -1)):
    p += [
        _link(f"{side}_uglut", UGLUT_MASS, np.diag([5e-3, 5e-3, 5e-3])),
        _joint(f"{side}_leg_hpz", "pelvis", f"{side}_uglut", (0, HIP_Y * sy, -0.09),
               (0, 0, 1), -0.78, 0.78),
        _link(f"{side}_lglut", UGLUT_MASS, np.diag([5e-3, 5e-3, 5e-3])),
        _joint(f"{side}_leg_hpx", f"{side}_uglut", f"{side}_lglut", (0, 0, 0), (1, 0, 0),
               -0.52, 0.52),
        _link(f"{side}_uleg", THIGH_MASS, _rod_inertia_z(THIGH_MASS, THIGH_LEN),
              com=(0, 0, -THIGH_LEN / 2)),
        _joint(f"{side}_leg_hpy", f"{side}_lglut", f"{side}_uleg", (0.05, 0, -0.05),
               (0, 1, 0), -1.61, 0.65),
        _link(f"{side}_lleg", SHIN_MASS, _rod_inertia_z(SHIN_MASS, SHIN_LEN),
              com=(0, 0, -SHIN_LEN / 2)),
        _joint(f"{side}_leg_kny", f"{side}_uleg", f"{side}_lleg", (0, 0, -THIGH_LEN),
               (0, 1, 0), 0.0, 2.35),
        _link(f"{side}_talus", 0.2, np.diag([1e-3, 1e-3, 1e-3])),
        _joint(f"{side}_leg_aky", f"{side}_lleg", f"{side}_talus", (0, 0, -SHIN_LEN),
               (0, 1, 0), -1.0, 0.7),
        _link(f"{side}_foot", FOOT_MASS,
              box(FOOT_MASS, 2 * FOOT_HALF[0], 2 * FOOT_HALF[1], 2 * FOOT_HALF[2]),
              com=(FOOT_FWD, 0, -ANKLE_DROP + FOOT_HALF[2]),
              collision=(f'<box size="{2*FOOT_HALF[0]} {2*FOOT_HALF[1]} {2*FOOT_HALF[2]}"/>',
                         (FOOT_FWD, 0, -ANKLE_DROP + FOOT_HALF[2]))),
        _joint(f"{side}_leg_akx", f"{side}_talus", f"{side}_foot", (0, 0, 0), (1, 0, 0),
               -0.8, 0.8),
        _link(f"{side}_clav", 1.0, np.diag([5e-3, 5e-3, 5e-3])),
        _joint(f"{side}_arm_shz", "utorso", f"{side}_clav", (0.05, SHOULDER_Y * sy, 0.35),
               (0, 0, 1), -1.57, 1.57),
        _link(f"{side}_uarm", UARM_MASS, _rod_inertia_z(UARM_MASS, UARM_LEN),
              com=(0, 0, -UARM_LEN / 2)),
        _joint(f"{side}_arm_shx", f"{side}_clav", f"{side}_uarm", (0, 0.05 * sy, 0),
               (1, 0, 0), -1.57, 1.57),
        _link(f"{side}_larm", LARM_MASS, _rod_inertia_z(LARM_MASS, LARM_LEN),
              com=(0, 0, -LARM_LEN / 2)),
        _joint(f"{side}_arm_ely", f"{side}_uarm", f"{side}_larm", (0, 0, -UARM_LEN),
               (0, 1, 0), 0.0, 2.35),
        _link(f"{side}_hand", 0.5, np.diag([1e-3, 1e-3, 1e-3])),
        _joint(f"{side}_arm_elx", f"{side}_larm", f"{side}_hand", (0, 0, -LARM_LEN),
               (1, 0, 0), -1.57, 1.57),
    ]
  p.append("</robot>")
  return "\n".join(p)


def joint_dofs(text: str) -> dict:
  """{joint name: its velocity index} in the parser's depth-first order of
  bodies (every joint below the floating base is revolute, one dof each)."""
  root = ET.fromstring(text)
  joints = [(j.get("name"), j.find("parent").get("link"), j.find("child").get("link"))
            for j in root.findall("joint") if j.get("type") == "revolute"]
  base = next(j.find("child").get("link") for j in root.findall("joint")
              if j.get("type") == "floating")
  dofs = {}

  def visit(link):
    for name, parent, child in joints:
      if parent == link:
        dofs[name] = 6 + len(dofs)
        visit(child)

  visit(base)
  return dofs


def standing_q() -> np.ndarray:
  """[pelvis position, quaternion wxyz, 23 joint angles] of the stance: knees
  bent by KNEE_BEND with the feet flat 1 mm above the ground, elbows at 0.5."""
  hpy, kny, aky = -KNEE_BEND / 2, KNEE_BEND, -KNEE_BEND / 2
  angles = {}
  for side in ("l", "r"):
    angles.update({f"{side}_leg_hpy": hpy, f"{side}_leg_kny": kny, f"{side}_leg_aky": aky,
                   f"{side}_arm_ely": 0.5})
  dofs = joint_dofs(atlas_urdf())
  q = np.zeros(7 + len(dofs))
  q[2] = 0.14 + THIGH_LEN * np.cos(hpy) + SHIN_LEN * np.cos(hpy + kny) + ANKLE_DROP + 0.001
  q[3] = 1.0
  for name, dof in dofs.items():
    q[dof + 1] = angles.get(name, 0.0)
  return q


def group_gains(pd_gains: dict, dofs: dict, nv: int):
  """(kp, kd) (nv,) numpy: each group's gains on the joints whose names hold
  its `match`, in the groups' order; zero elsewhere (the floating base)."""
  kp, kd = np.zeros(nv), np.zeros(nv)
  for grp in pd_gains["groups"]:
    for name, dof in dofs.items():
      if grp["match"] in name:
        kp[dof], kd[dof] = float(grp["kp"]), float(grp["kd"])
  return kp, kd


class Scene(step.Scene):
  """The scene of the `atlas` configuration's `world` section (the humanoid
  on the ground plane, per-group PD gains), in `dtype` on `device`."""

  def __init__(self, world: dict, dtype=torch.float64, device="cpu"):
    kinds = sorted(o["type"] for o in world["objects"])
    robot = next((o for o in world["objects"] if o["type"] == "urdf"), None)
    if kinds != ["ground", "urdf"] or robot["model"] != "atlas":
      raise ValueError(f"objects {world['objects']}: this scene holds the Atlas-class "
                       "humanoid on the ground plane")
    text = atlas_urdf()
    bodies, geoms = model.parse_urdf(text)
    self.model = m = model.build_model(bodies)
    self.T = dynamics.Tables(m, dtype, device)
    self.dt = float(world["dt"])
    self.gravity = torch.tensor(world.get("gravity", (0.0, 0.0, -9.81)), dtype=dtype,
                                device=device)
    t = dict(dtype=dtype, device=device)
    corners = torch.tensor(collide.CORNERS, **t)
    self.pair_geoms = [dict(g, offset_pos_t=torch.tensor(g["offset_pos"], **t),
                            offset_rot_t=torch.tensor(g["offset_rot"], **t),
                            params_t=torch.tensor(g["params"], **t),
                            corners_t=torch.tensor(g["params"][:3], **t) * corners)
                       for g in geoms]
    slot_body = [g["body"] for g in geoms for _ in range(1 if g["gtype"] == 0 else 8)]
    self.n_slots = len(slot_body)
    self.slot_mask = self.T.amask[torch.as_tensor(slot_body, device=device)]
    ground = next(o for o in world["objects"] if o["type"] == "ground")
    self.ground_height = float(ground.get("height", 0.0))
    self.field_size, self.has_field = (0.0, 0.0), False
    kp, kd = group_gains(world["pd_gains"], joint_dofs(text), m.nv)
    act = self.T.actuated
    self.kp, self.D = torch.tensor(kp, **t) * act, torch.tensor(kd, **t) * act
    limit_v = [j for j in range(m.nv) if m.joint_lo[j] > -1e8 or m.joint_hi[j] < 1e8]
    self.limit_v = torch.as_tensor(limit_v, device=device)
    self.limit_q = torch.as_tensor([m.q_adr[m.v_adr.index(j)] for j in limit_v], device=device)
    self.lim_lo = torch.tensor(m.joint_lo[limit_v], **t)
    self.lim_hi = torch.tensor(m.joint_hi[limit_v], **t)
    self.limit_onehot = torch.zeros((len(limit_v), m.nv), **t)
    self.limit_onehot[torch.arange(len(limit_v)), limit_v] = 1.0
    jq, jmask = np.zeros(m.nv, dtype=np.int64), np.zeros(m.nv)
    for i in range(m.nb):
      if m.joint[i] == model.REVOLUTE:
        jq[m.v_adr[i]], jmask[m.v_adr[i]] = m.q_adr[i], 1.0
    self.jq, self.jmask = torch.as_tensor(jq, device=device), torch.tensor(jmask, **t)
    self.kinds = ("cone",) * self.n_slots + ("lin",) * len(limit_v)
    self.dtype, self.device = dtype, device
