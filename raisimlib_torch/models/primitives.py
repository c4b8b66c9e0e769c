"""Hand-built benchmark models: pendulum, double pendulum, cartpole, free bodies.

Counterpart of raisimlib_tpu/models/primitives.py, with the same spec dicts
and defaults: the smooth-dynamics systems of BASELINE config 1 (the
cartpole swing-up) and the conservation checks. Each builds on `device`
(None: the card, see _device.resolve_device).
"""

from __future__ import annotations

import numpy as np
import torch

from raisimlib_torch.models.model import JointType, build_model


def _rod_inertia(m, l, axis="x"):
  """Inertia of a thin rod of length l about its COM, extended along +z."""
  i = m * l * l / 12.0
  return np.diag([i, i, 1e-8 * m])


def pendulum(m=1.0, l=1.0, dtype=torch.float32, device=None):
  """Single pendulum: revolute about world y-axis, rod hanging along -z at q=0."""
  return build_model(
      "pendulum",
      [dict(parent=-1, joint=JointType.REVOLUTE, axis=[0.0, 1.0, 0.0], pos=[0.0, 0.0, 0.0],
            mass=m, com=[0.0, 0.0, -l / 2], inertia=_rod_inertia(m, l), name="rod")],
      dtype=dtype, device=device)


def double_pendulum(m1=1.0, m2=1.0, l1=1.0, l2=1.0, dtype=torch.float32, device=None):
  return build_model(
      "double_pendulum",
      [dict(parent=-1, joint=JointType.REVOLUTE, axis=[0.0, 1.0, 0.0], pos=[0.0, 0.0, 0.0],
            mass=m1, com=[0.0, 0.0, -l1 / 2], inertia=_rod_inertia(m1, l1), name="link1"),
       dict(parent=0, joint=JointType.REVOLUTE, axis=[0.0, 1.0, 0.0], pos=[0.0, 0.0, -l1],
            mass=m2, com=[0.0, 0.0, -l2 / 2], inertia=_rod_inertia(m2, l2), name="link2")],
      dtype=dtype, device=device)


def cartpole(mc=1.0, mp=0.1, l=0.5, dtype=torch.float32, device=None):
  """Cart (prismatic along x) + pole (revolute about y); pole up is q1 = pi."""
  return build_model(
      "cartpole",
      [dict(parent=-1, joint=JointType.PRISMATIC, axis=[1.0, 0.0, 0.0], pos=[0.0, 0.0, 0.0],
            mass=mc, com=[0.0, 0.0, 0.0], inertia=np.eye(3) * 1e-6, name="cart"),
       dict(parent=0, joint=JointType.REVOLUTE, axis=[0.0, 1.0, 0.0], pos=[0.0, 0.0, 0.0],
            mass=mp, com=[0.0, 0.0, -l / 2], inertia=_rod_inertia(mp, l), actuated=False,
            name="pole")],
      dtype=dtype, device=device)


def free_box(m=1.0, half_extents=(0.1, 0.1, 0.1), dtype=torch.float32, device=None):
  hx, hy, hz = half_extents
  I = m / 3.0 * np.diag([hy * hy + hz * hz, hx * hx + hz * hz, hx * hx + hy * hy])
  return build_model(
      "free_box",
      [dict(parent=-1, joint=JointType.FREE, mass=m, com=[0.0, 0.0, 0.0], inertia=I,
            actuated=False, name="box")],
      dtype=dtype, device=device)


def free_sphere(m=1.0, radius=0.1, dtype=torch.float32, device=None):
  I = 0.4 * m * radius * radius * np.eye(3)
  return build_model(
      "free_sphere",
      [dict(parent=-1, joint=JointType.FREE, mass=m, com=[0.0, 0.0, 0.0], inertia=I,
            actuated=False, name="sphere")],
      dtype=dtype, device=device)
