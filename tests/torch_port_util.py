"""Shared helpers of the port's parity tests (tests/test_torch_*.py): build
the ANYmal main-path scene in both packages, and flatten a JAX Scene into the
numpy arrays + plain-Python static data that raisimlib_torch.convert takes.
JAX is imported only inside the JAX-side helpers, so that the card's tests
(tests/test_torch_cuda.py) run where JAX is not installed."""

import os

import numpy as np
import torch

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
MODEL_FIELDS = ("X_rot", "X_pos", "axis", "inertia", "mass", "actuated",
                "torque_limit", "joint_lo", "joint_hi", "q_init")


def load_golden(name="anymal_balance.npz"):
  return np.load(os.path.join(GOLDEN_DIR, name))


def jax_anymal_scene(dtype=None, dt=0.0025, kp=100.0, kd=2.0):
  import jax.numpy as jnp
  from raisimlib_tpu.models import anymal
  from raisimlib_tpu.models.urdf import load_urdf
  from raisimlib_tpu.world import World

  bodies, geoms, _ = load_urdf(anymal.anymal_urdf())
  world = World(dt=dt, dtype=jnp.float64 if dtype is None else dtype)
  world.add_articulated_system(bodies, name="anymal", geoms=geoms)
  world.add_ground()
  return world.compile().set_pd_gains(kp, kd)


def torch_anymal_scene(dtype=torch.float64, dt=0.0025, kp=100.0, kd=2.0):
  from raisimlib_torch.models import anymal
  from raisimlib_torch.models.urdf import load_urdf
  from raisimlib_torch.world import World

  bodies, geoms, _ = load_urdf(anymal.anymal_urdf())
  world = World(dt=dt, dtype=dtype, device="cpu")
  world.add_articulated_system(bodies, name="anymal", geoms=geoms)
  world.add_ground()
  return world.compile().set_pd_gains(kp, kd)


def flatten_jax_scene(scene):
  """JAX Scene -> (arrays, static) for raisimlib_torch.convert.scene_from_numpy."""
  m, g = scene.model, scene.geoms
  arrays = {f: np.asarray(getattr(m, f)) for f in MODEL_FIELDS}
  arrays.update(geom_params=np.asarray(g.params),
                geom_offset_pos=np.asarray(g.offset_pos),
                geom_offset_rot=np.asarray(g.offset_rot),
                materials=np.asarray(scene.materials),
                gravity=np.asarray(scene.gravity),
                kp=np.asarray(scene.kp), kd=np.asarray(scene.kd))
  static = dict(name=m.name, parent=m.parent, joint_types=m.joint_types,
                q_adr=m.q_adr, v_adr=m.v_adr, nq=m.nq, nv=m.nv,
                body_names=m.body_names, gtype=g.gtype, geom_body=g.body,
                geom_material=g.material, pairs=scene.pairs,
                constraints=tuple(scene.constraints), dt=scene.dt,
                objects=scene.objects)
  return arrays, static


def perturbed_states(g, B, seed, dq=1e-3, du=1e-2):
  """B states around the golden's SETTLED q0/u0 (never raw standing_q, a knife
  edge where a 1e-7 change flips a contact branch), quaternion renormalised."""
  rng = np.random.default_rng(seed)
  q = np.tile(g["q0"], (B, 1)) + dq * rng.standard_normal((B, g["q0"].size))
  q[:, 3:7] /= np.linalg.norm(q[:, 3:7], axis=1, keepdims=True)
  u = np.tile(g["u0"], (B, 1)) + du * rng.standard_normal((B, g["u0"].size))
  return q, u


def anymal_factors(B, seed=0):
  """The main path's solver inputs (12 cone + 12 lin rows, nv = 18) from
  perturbed settled ANYmal states, as float32 numpy, and the row kinds."""
  from raisimlib_torch.ops import pipeline
  from raisimlib_torch.ops.integrator import State

  g = load_golden()
  scene = torch_anymal_scene()
  q, u = perturbed_states(g, B, seed)
  state = State(q=torch.tensor(q), u=torch.tensor(u), t=torch.zeros(B, dtype=torch.float64))
  tgt = torch.tensor(np.tile(g["pd_targets"][0], (B, 1)))
  with torch.inference_mode():
    args, cfg = pipeline.solver_inputs(scene, state, torch.zeros_like(tgt), tgt)
  return [a.numpy().astype(np.float32) for a in args], cfg.row_kinds
