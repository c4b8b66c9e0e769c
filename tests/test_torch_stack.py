"""The sphere-box stack (BASELINE config 2) and the other loose-body scenes
of the port, against the JAX package:

  * World.add_sphere / add_box (dynamic, static, turned) / add_capsule build
    the JAX World's tables: masses, inertias, geoms, pairs;
  * convert.scene_from_numpy carries the JAX loose-body scenes across as
    they are;
  * chip_smoke.py's stack constants are the scenario file's;
  * pipeline.step_batch(use_kernel=False) against JAX's, 40 steps, f64;
  * tests/goldens/sphere_box_stack.npz through Scene.step (f32, 400 steps)
    under the JAX package's gate, and through the batched paths: the fused
    step's generated body (compiled as host C++) for the whole window and the
    K2 twin for the kick and the slide;
  * the fused step's gradients on the stack.

The JAX scenes cross over through convert.scene_from_numpy where a test
needs the same numbers in both packages."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import MODEL_FIELDS, flatten_jax_scene, host_step, load_golden
from torch_port_util import one_thread  # noqa: F401  (a module fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
  spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod


CS = _chip_smoke()


def _rot_z(a):
  c, s = np.cos(a), np.sin(a)
  return [[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]]


def _jax_scene(name, dtype=jnp.float64):
  """The JAX package's build of each of chip_smoke.py's loose-body scenes."""
  from raisimlib_tpu import scenarios
  from raisimlib_tpu.world import World

  if name == "stack":
    world, _ = scenarios.build_world(scenarios.load("sphere_box_stack"), dtype=dtype)
    return world.compile()
  world = World(dt=0.002, dtype=dtype)
  world.add_ground()
  if name == "spheres_capsule":
    world.add_sphere(0.1, 1.0, pos=(0.0, 0.0, 0.11), name="a")
    world.add_sphere(0.1, 1.0, pos=(0.12, 0.0, 0.28), name="b")
    world.add_capsule(0.06, 0.15, 0.5, pos=(1.0, 0.0, 0.07), name="c")
  else:
    world.add_box((0.3, 0.2, 0.1), 0.0, pos=(0.0, 0.0, 0.1), static=True, rot=_rot_z(0.3))
    world.add_sphere(0.1, 1.0, pos=(0.05, 0.02, 0.3))
  return world.compile(joint_limits=False)


def _port_scene(name, dtype=torch.float64):
  build = {"stack": CS.stack_scene, "spheres_capsule": CS.spheres_capsule_scene,
           "static_box": CS.static_box_scene}[name]
  return build(torch, device="cpu", dtype=dtype)


SCENES = ["stack", "spheres_capsule", "static_box"]


@pytest.mark.parametrize("name", SCENES)
def test_world_api_matches_jax(name):
  """The port's add_sphere / add_box / add_capsule give the JAX World's
  model (FREE roots, masses, inertias, q_init), geom tables and pairs."""
  js, ts = _jax_scene(name), _port_scene(name)
  m, mt = js.model, ts.model
  assert (mt.parent, mt.joint_types, mt.q_adr, mt.v_adr) == (
      m.parent, m.joint_types, m.q_adr, m.v_adr)
  for f in ("mass", "inertia", "X_rot", "X_pos", "q_init", "actuated"):
    np.testing.assert_array_equal(getattr(mt, f).numpy(), np.asarray(getattr(m, f)), err_msg=f)
  g, gt = js.geoms, ts.geoms
  assert (gt.gtype, gt.body, gt.material) == (g.gtype, g.body, g.material)
  for f in ("params", "offset_pos", "offset_rot"):
    np.testing.assert_array_equal(getattr(gt, f).numpy(), np.asarray(getattr(g, f)), err_msg=f)
  assert ts.pairs == js.pairs
  np.testing.assert_array_equal(ts.materials.numpy(), np.asarray(js.materials))
  assert ts.dt == js.dt


@pytest.mark.parametrize("name", SCENES)
def test_scene_from_numpy_carries_the_jax_scene(name):
  """A JAX loose-body scene flattened to numpy crosses over as it is: the
  model, the geom tables, the pairs and the objects of the port's own
  World build, exactly."""
  from raisimlib_torch.convert import scene_from_numpy

  js, ts = _jax_scene(name), _port_scene(name)
  cs = scene_from_numpy(*flatten_jax_scene(js), device="cpu", dtype=torch.float64)
  m, mt = cs.model, ts.model
  assert (m.parent, m.joint_types, m.q_adr, m.v_adr, m.body_names) == (
      mt.parent, mt.joint_types, mt.q_adr, mt.v_adr, mt.body_names)
  for f in MODEL_FIELDS:
    np.testing.assert_array_equal(getattr(m, f).numpy(), getattr(mt, f).numpy(), err_msg=f)
  assert (cs.geoms.gtype, cs.geoms.body, cs.geoms.material) == (
      ts.geoms.gtype, ts.geoms.body, ts.geoms.material)
  for f in ("params", "offset_pos", "offset_rot"):
    np.testing.assert_array_equal(getattr(cs.geoms, f).numpy(), getattr(ts.geoms, f).numpy(),
                                  err_msg=f)
  assert cs.pairs == ts.pairs == js.pairs
  assert cs.objects == ts.objects == js.objects
  assert cs.constraints == ts.constraints


def test_chip_smoke_stack_constants_match_the_scenario():
  """chip_smoke.py carries the scenario's values (the card's machine has no
  PyYAML): they must be the file's."""
  from raisimlib_tpu import scenarios

  cfg = scenarios.load("sphere_box_stack")
  w, run = cfg["world"], cfg["run"]
  objs = {o["type"]: o for o in w["objects"]}
  assert [o["type"] for o in w["objects"]] == ["ground", "box", "sphere"]
  st = CS.STACK
  assert st["dt"] == w["dt"] and list(st["gravity"]) == w["gravity"]
  assert list(st["box"]["half_extents"]) == objs["box"]["half_extents"]
  assert st["box"]["mass"] == objs["box"]["mass"]
  assert list(st["box"]["pos"]) == objs["box"]["pos"]
  assert st["sphere"]["radius"] == objs["sphere"]["radius"]
  assert st["sphere"]["mass"] == objs["sphere"]["mass"]
  assert list(st["sphere"]["pos"]) == objs["sphere"]["pos"]
  assert st["sim_seconds"] == run["sim_seconds"] and st["kick_m_s"] == run["kick_m_s"]
  assert st["gates"] == run["gates"]


def _states(q0, nv, B, seed, dq=1e-3, du=1e-2, free_q=()):
  """B states around q0: noise dq on q (the quaternions at `free_q`
  renormalised) and du on u."""
  rng = np.random.RandomState(seed)
  q = np.tile(q0[None], (B, 1)) + dq * rng.randn(B, q0.size)
  for qa in free_q:
    q[:, qa:qa + 4] /= np.linalg.norm(q[:, qa:qa + 4], axis=1, keepdims=True)
  return q, du * rng.randn(B, nv)


@pytest.mark.parametrize("name", ["stack", "spheres_capsule"])
def test_step_batch_matches_jax_pure_path(name):
  """40 steps of 4 worlds (the stack kicked 0.3 m/s, sliding and landing;
  the spheres and the capsule settling), f64: the port's
  pipeline.step_batch(use_kernel=False) against the JAX package's. The same
  algorithm (the reference solver's grid + Newton); only float64 rounding
  separates them: 1e-9."""
  from raisimlib_tpu.ops import pipeline as jp
  from raisimlib_tpu.ops.integrator import State as JState
  from raisimlib_torch.ops import pipeline as tp
  from raisimlib_torch.ops.integrator import State

  js, ts = _jax_scene(name), _port_scene(name)
  m = ts.model
  q, u = _states(m.q_init.numpy(), m.nv, 4, seed=3,
                 free_q=[m.q_adr[b] + 3 for b in range(m.nb)])
  if name == "stack":
    u[:, 3] += 0.3
  tau = np.zeros((4, m.nv))

  def roll(s):
    return jax.lax.scan(lambda s, _: (jp.step_batch(js, s, jnp.asarray(tau), None,
                                                    use_kernel=False), None),
                        s, None, length=40)[0]

  sj = jax.jit(roll)(JState(q=jnp.asarray(q), u=jnp.asarray(u), t=jnp.zeros(4)))
  s = State(q=torch.tensor(q), u=torch.tensor(u), t=torch.zeros(4, dtype=torch.float64))
  with torch.inference_mode():
    for _ in range(40):
      s = tp.step_batch(ts, s, torch.tensor(tau), use_kernel=False)
  np.testing.assert_allclose(s.q.numpy(), np.asarray(sj.q), rtol=0, atol=1e-9)
  np.testing.assert_allclose(s.u.numpy(), np.asarray(sj.u), rtol=0, atol=1e-9)


def test_golden_replay_through_scene_step():
  """tests/goldens/sphere_box_stack.npz, 400 steps in f32 through the
  reference step Scene.step, under the JAX package's own gate
  (tests/test_parity.py): max|dq| <= 1e-4, the box resting at z = 0.15 and
  the sphere at 0.42 within 2e-3 (chip_smoke.stack_golden, as phase 19 runs
  it on the card)."""
  assert CS.stack_golden(torch, CS.reference_step, "Scene.step", device="cpu") <= 1e-4


def test_batched_paths_hold_the_stack_gate(tmp_path):
  """The batched paths under the same gate: the fused step's generated body
  (the kernel's arithmetic, compiled as host C++ without FMA contraction)
  over all 400 steps, and the K2 twin (Scene.step_batch on the CPU) over
  the first 15, the kick and the start of the slide. Neither parts from the reference
  (their float32 deviation stays near 4e-7, tools/stack_golden_gate.py), so
  the stack needs no two-part gate."""
  from raisimlib_torch.ops import gpu_step, pipeline
  from raisimlib_torch.ops.integrator import State
  from raisimlib_torch.utils import parity

  g = load_golden("sphere_box_stack.npz")
  scene = _port_scene("stack", torch.float32)
  host = host_step(gpu_step._analyze(scene, pipeline.StepConfig(), False), tmp_path)
  q, u = g["q0"][None].astype(np.float32), g["u0"][None].astype(np.float32)
  zero = np.zeros_like(u)
  qs = []
  for _ in range(int(g["N"])):
    qo, uo = np.zeros_like(q), np.zeros_like(u)
    host(q.ctypes.data, u.ctypes.data, zero.ctypes.data, zero.ctypes.data, None, 0,
         qo.ctypes.data, uo.ctypes.data, 1)
    q, u = qo, uo
    qs.append(q[0])
  assert parity.stack_gate_failures(np.stack(qs), g) == []

  s = State(q=torch.tensor(g["q0"][None], dtype=torch.float32),
            u=torch.tensor(g["u0"][None], dtype=torch.float32), t=torch.zeros(1))
  qs = []
  with torch.inference_mode():
    for _ in range(15):
      s = scene.step_batch(s)
      qs.append(s.q[0].numpy())
  assert parity.stack_gate_failures(np.stack(qs), g) == []


def test_fused_gradients_equal_step_batch():
  """Through make_step_batch_fused on the CPU the backward differentiates
  pipeline.step_batch: on the stack (the sphere on the box, both on the
  ground, the box sliding), the same gradients w.r.t. q, u and tau, f64."""
  from raisimlib_torch.ops import gpu_step
  from raisimlib_torch.ops import pipeline as tp
  from raisimlib_torch.ops.integrator import State

  ts = _port_scene("stack")
  g = load_golden("sphere_box_stack.npz")
  q, u = g["q"][300][None], g["u"][300][None] + 0.3 * np.eye(12)[3]
  fused = gpu_step.make_step_batch_fused(ts, use_pd=False)
  grads = []
  for stepfn in (lambda s, tau: fused(s, tau), lambda s, tau: tp.step_batch(ts, s, tau)):
    xs = [torch.tensor(x, requires_grad=True) for x in (q, u, np.zeros((1, 12)))]
    out = stepfn(State(q=xs[0], u=xs[1], t=torch.zeros(1, dtype=torch.float64)), xs[2])
    loss = (out.q ** 2).sum() + (out.u[:, 3] ** 3).sum() + out.u[:, 9].sum()
    grads.append(torch.autograd.grad(loss, xs))
  for gf, gp in zip(*grads):
    np.testing.assert_allclose(gf.numpy(), gp.numpy(), rtol=1e-12, atol=1e-12)
  assert float(grads[0][1].abs().sum()) > 0.0
