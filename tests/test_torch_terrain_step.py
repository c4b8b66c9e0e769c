"""The port's terrain step against the JAX package and the trot golden.

  * A FREE body with a box and a sphere over per-world random heightmaps
    (cells steeper than the riser march's gate), built in JAX and carried
    across with convert.scene_from_numpy: the port's pipeline.step_batch(
    field_heights=...) against JAX's step_batch(use_kernel=False) in float64
    (1e-9: the twin's cone search and the reference's differ only where a
    slip angle is searched, and these worlds stick or lift off), and the
    fused step's twin (K1c) in float32 against the same float64 run (5e-4 on
    q, 5e-3 on u: the kernel-vs-pure bounds of tests/test_torch_step.py).
  * The fused step's gradient differentiates pipeline.step_batch with the
    step's own heights, and its argument checks.
  * ANYmal on tests/goldens/anymal_trot_heightmap.npz, without JAX: the
    reference Scene.step over all 80 steps and the fused twin over the
    first 3, under the trot gates of raisimlib_torch/utils/parity.py.
  * mppi_step_batch(env_ctx=...) against a hand loop over the same samples.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import GOLDEN_DIR, flatten_jax_scene

from raisimlib_tpu.models.model import JointType
from raisimlib_tpu.ops import collision as jcoll
from raisimlib_tpu.ops import heightmap as jhm
from raisimlib_tpu.world import World as JWorld
from raisimlib_torch.models.model import JointType as TJ

B, STEPS, NX, NY = 4, 5, 13, 11


def _jax_scene(dtype):
  world = JWorld(dt=0.004, dtype=dtype)
  world.add_articulated_system(
      [dict(parent=-1, joint=JointType.FREE, mass=3.0, com=[0, 0, 0],
            inertia=np.diag([0.04, 0.05, 0.06]), name="lander", actuated=False)],
      name="lander",
      geoms=[dict(body=0, gtype=jcoll.GEOM_BOX, params=[0.15, 0.1, 0.05]),
             dict(body=0, gtype=jcoll.GEOM_SPHERE, params=[0.08], offset_pos=[0.0, 0.0, -0.1])])
  world.add_heightmap(jhm.HeightField(heights=jnp.zeros((NX, NY), dtype),
                                      center=jnp.asarray([0.1, -0.05], dtype),
                                      size_x=2.4, size_y=2.0))
  return world.compile(joint_limits=False)


@pytest.fixture(scope="module")
def lander():
  """(JAX f64 scene, the port's f64 and f32 scenes, per-world heights, q0, u0)."""
  from raisimlib_torch import convert

  js = _jax_scene(jnp.float64)
  arrays, static = flatten_jax_scene(js)
  ports = {d: convert.scene_from_numpy(arrays, static, device="cpu", dtype=d)
           for d in (torch.float32, torch.float64)}
  rng = np.random.RandomState(5)
  hts = rng.uniform(-0.12, 0.12, (B, NX, NY))
  q = np.zeros((B, 7))
  q[:, :2] = rng.uniform(-0.3, 0.3, (B, 2))
  q[:, 2] = 0.2 + rng.uniform(-0.04, 0.02, B)
  quat = np.array([1.0, 0.0, 0.0, 0.0]) + 0.15 * rng.randn(B, 4)
  q[:, 3:] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
  u = 0.4 * rng.randn(B, 6)
  u[:, 5] = -0.5                                  # falling onto the terrain
  return js, ports, hts, q, u


@pytest.fixture(scope="module")
def jax_rollout(lander):
  from raisimlib_tpu.ops import pipeline as jp
  from raisimlib_tpu.ops.integrator import State as JState

  js, _, hts, q, u = lander
  h = jnp.asarray(hts)

  def roll(s):
    step = lambda s, _: (jp.step_batch(js, s, jnp.zeros((B, 6)), None, field_heights=h,  # noqa: E731
                                       use_kernel=False), None)
    return jax.lax.scan(step, s, None, length=STEPS)[0]

  s = jax.jit(roll)(JState(q=jnp.asarray(q), u=jnp.asarray(u), t=jnp.zeros(B)))
  return np.asarray(s.q), np.asarray(s.u)


def _roll_port(scene, stepfn, hts, q, u, dtype):
  from raisimlib_torch.ops.integrator import State

  h = torch.tensor(hts, dtype=dtype)
  s = State(q=torch.tensor(q, dtype=dtype), u=torch.tensor(u, dtype=dtype),
            t=torch.zeros(B, dtype=dtype))
  depth_max = 0.0
  with torch.inference_mode():
    for _ in range(STEPS):
      s = stepfn(s, torch.zeros((B, 6), dtype=dtype), h)
      depth_max = max(depth_max, _max_depth(scene, s, h))
  return s.q.numpy(), s.u.numpy(), depth_max


def _max_depth(scene, s, h):
  from raisimlib_torch.ops import collision as coll
  from raisimlib_torch.ops import dynamics

  c = coll.collide(scene.geoms, scene.pairs, dynamics.fk(scene.model, s.q),
                   scene.field.replace(heights=h))
  return float((c.depth * c.active).max())


def test_step_batch_on_terrain_matches_jax_f64(lander, jax_rollout):
  from raisimlib_torch.ops import pipeline

  js, ports, hts, q, u = lander
  ts = ports[torch.float64]
  qt, ut, depth = _roll_port(
      ts, lambda s, tau, h: pipeline.step_batch(ts, s, tau, field_heights=h),
      hts, q, u, torch.float64)
  qj, uj = jax_rollout
  assert depth > 1e-3                             # the worlds are in contact
  np.testing.assert_allclose(qt, qj, atol=1e-9, rtol=0)
  np.testing.assert_allclose(ut, uj, atol=1e-9, rtol=0)


def test_fused_twin_on_terrain_matches_jax_f32(lander, jax_rollout):
  """K1c's twin (make_step_batch_fused on CPU tensors), float32."""
  from raisimlib_torch.ops import gpu_step

  _, ports, hts, q, u = lander
  ts = ports[torch.float32]
  step = gpu_step.make_step_batch_fused(ts, use_pd=False)
  assert {s.kind for s in step.sd.slots} == {"hm_pt"} and len(step.sd.slots) == 9
  qt, ut, _ = _roll_port(ts, lambda s, tau, h: step(s, tau, field_heights=h),
                         hts, q, u, torch.float32)
  qj, uj = jax_rollout
  np.testing.assert_allclose(qt, qj, atol=5e-4, rtol=1e-4)
  np.testing.assert_allclose(ut, uj, atol=5e-3, rtol=1e-3)


def test_fused_gradient_uses_the_step_heights(lander):
  """The backward differentiates pipeline.step_batch with the heights the
  forward read (per world, and the scene's field by default), as the JAX
  custom VJP does; the gradient w.r.t. the heights comes along. Two sweeps on
  both sides keep the reference solve's graph small."""
  from raisimlib_torch.ops import contact, gpu_step, pipeline
  from raisimlib_torch.ops.integrator import State

  _, ports, hts, q, u = lander
  ts = ports[torch.float64]
  cfg = pipeline.StepConfig(solver=contact.SolverConfig(sweeps=2))
  fused = gpu_step.make_step_batch_fused(ts, cfg, use_pd=False)
  q1 = q.copy()
  q1[:, 2] -= 0.04                                # start in contact
  for per_world in (True, False):
    grads = []
    for stepfn in (lambda s, h: fused(s, torch.zeros((B, 6), dtype=torch.float64),
                                      field_heights=h),
                   lambda s, h: pipeline.step_batch(ts, s, torch.zeros((B, 6), dtype=torch.float64),
                                                    config=cfg, field_heights=h)):
      xs = [torch.tensor(x, requires_grad=True) for x in (q1, u)]
      h = (torch.tensor(hts, requires_grad=True) if per_world
           else ts.field.heights.expand(B, NX, NY))
      out = stepfn(State(q=xs[0], u=xs[1], t=torch.zeros(B, dtype=torch.float64)),
                   h if per_world else None)
      loss = (out.q[:, :3] ** 2).sum() + (out.u ** 2).sum()
      grads.append(torch.autograd.grad(loss, xs + ([h] if per_world else [])))
    for gf, gp in zip(*grads):
      np.testing.assert_allclose(gf.numpy(), gp.numpy(), rtol=1e-12, atol=1e-12)
    assert float(grads[0][0].abs().max()) > 0
  assert float(grads[0][0][:, 2].abs().max()) > 0


def test_fused_step_checks_its_heights(lander):
  from raisimlib_torch.ops import gpu_step
  from raisimlib_torch.ops.integrator import State

  _, ports, hts, q, u = lander
  ts = ports[torch.float64]
  step = gpu_step.make_step_batch_fused(ts, use_pd=False)
  s = State(q=torch.tensor(q), u=torch.tensor(u), t=torch.zeros(B, dtype=torch.float64))
  tau = torch.zeros((B, 6), dtype=torch.float64)
  with pytest.raises(ValueError, match="shape"):
    step(s, tau, field_heights=torch.zeros((B, NX + 1, NY), dtype=torch.float64))
  with pytest.raises(ValueError, match="is on meta"):
    step(s, tau, field_heights=torch.zeros((B, NX, NY), device="meta"))
  flat = ts.replace(field=None, pairs=(), geoms=ts.geoms)
  with pytest.raises(ValueError, match="without a heightmap"):
    gpu_step.make_step_batch_fused(flat, use_pd=False)(s, tau, field_heights=torch.tensor(hts))


# ---- ANYmal on the trot golden --------------------------------------------------


@pytest.fixture(scope="module")
def trot():
  """The golden and the port's f32 ANYmal scene over its heights (built on a
  flat 12 x 6 m, 48 x 24 field, then given the golden's heights, as
  tests/test_parity.py does)."""
  from raisimlib_torch.models import anymal
  from raisimlib_torch.models.urdf import load_urdf
  from raisimlib_torch.utils import terrain
  from raisimlib_torch.world import World

  g = np.load(f"{GOLDEN_DIR}/anymal_trot_heightmap.npz")
  bodies, geoms, _ = load_urdf(anymal.anymal_urdf())
  world = World(dt=float(g["dt"]), dtype=torch.float32, device="cpu")
  world.add_articulated_system(bodies, name="anymal", geoms=geoms)
  world.add_heightmap(terrain.flat(0.0, size=(12.0, 6.0), samples=(48, 24), device="cpu"))
  scene = world.compile().set_pd_gains(float(g["kp"]), float(g["kd"]))
  scene = scene.replace(field=scene.field.replace(
      heights=torch.tensor(g["heights"], dtype=torch.float32)))
  return g, scene


def test_trot_golden_scene_step_f32(trot):
  """The reference step over the whole 80-step window (feet lift off and
  touch down in it): tests/test_parity.py's trot gate, >= 95% of
  applied-torque entries within 1e-3 N m and none above 0.5 N m."""
  from raisimlib_torch.utils import parity

  g, scene = trot
  s = scene.init_state(q=g["q0"], u=g["u0"])
  qs, us = [], []
  with torch.inference_mode():
    for tgt in g["pd_targets"]:
      s = scene.step(s, pd_target=torch.tensor(tgt, dtype=torch.float32))
      qs.append(s.q.numpy())
      us.append(s.u.numpy())
  qs, us = np.stack(qs), np.stack(us)
  assert not parity.trot_gate_failures(qs, us, g), parity.trot_gate_failures(qs, us, g)
  assert parity.trot_deviation(qs, us, g).max() < 1e-4     # measured 1.7e-5


def test_trot_golden_fused_twin_first_steps(trot):
  """K1c's twin at B = 2 over the first 3 steps, under the trot gate."""
  from raisimlib_torch.ops import gpu_step
  from raisimlib_torch.utils import parity

  g, scene = trot
  step = gpu_step.make_step_batch_fused(scene)
  assert len(step.sd.slots) == 12 and step.sd.hm.nx == 48
  s = scene.init_state(q=np.tile(g["q0"], (2, 1)), u=np.tile(g["u0"], (2, 1)))
  qs, us = [], []
  with torch.inference_mode():
    for tgt in g["pd_targets"][:3]:
      pd = torch.tensor(np.tile(tgt, (2, 1)), dtype=torch.float32)
      s = step(s, torch.zeros_like(pd), pd)
      qs.append(s.q.numpy())
      us.append(s.u.numpy())
  qs, us = np.stack(qs), np.stack(us)
  assert np.array_equal(qs[:, 0], qs[:, 1])
  assert not parity.trot_gate_failures(qs[:, 0], us[:, 0], g)
  assert parity.trot_deviation(qs[:, 0], us[:, 0], g).max() < 1e-4


# ---- MPPI over per-environment terrains ------------------------------------------


def test_mppi_env_ctx_matches_hand_loop(lander):
  """E = 2 environments x K = 4 samples x H = 3 steps on the lander, each
  environment on its own terrain: mppi_step_batch(env_ctx=heights) equals a
  loop that repeats each environment's heights over its samples, and the
  costs see each environment's own terrain."""
  from raisimlib_torch.mpc import mppi, state_map
  from raisimlib_torch.ops import heightmap as hm

  _, ports, hts, q, u = lander
  ts = ports[torch.float64]
  E, K, H = 2, 4, 3
  dyn_b, nx, nu = state_map.make_contact_dyn_batch(ts, ts.dt, 1, use_pd=False)
  heights = torch.tensor(hts[:E])

  def rc(X, A, t, h):
    z, _, _ = hm.surface_at(ts.field.replace(heights=h), X[:, :2])
    return (X[:, 2] - z - 0.2) ** 2 + 0.01 * (A ** 2).sum(1)

  def fc(X, h):
    z, _, _ = hm.surface_at(ts.field.replace(heights=h), X[:, :2])
    return 10.0 * (X[:, 2] - z - 0.2) ** 2

  x0s = torch.tensor(np.concatenate([q[:E], u[:E]], 1))
  Us = torch.zeros((E, H, nu), dtype=torch.float64)
  eps = torch.tensor(np.random.default_rng(8).standard_normal((E, K, H, nu)))
  cfg = mppi.MPPIConfig(n_samples=K, sigma=1.0, temperature=0.5)
  with torch.inference_mode():
    sol = mppi.mppi_step_batch(dyn_b, rc, fc, x0s, Us, config=cfg, eps_white=eps,
                               env_ctx=heights)
    Usamp = Us[:, None] + mppi._colorize(eps, cfg.smooth)
    Usamp[:, 0] = Us
    X = x0s.repeat_interleave(K, 0)
    rows = heights.repeat_interleave(K, 0)
    acc = torch.zeros(E * K, dtype=torch.float64)
    for t in range(H):
      A = Usamp.reshape(E * K, H, nu)[:, t]
      acc = acc + rc(X, A, t, rows)
      X = dyn_b(X, A, t, rows)
    costs = (acc + fc(X, rows)).reshape(E, K)
    swapped = fc(X, heights.flip(0).repeat_interleave(K, 0)).reshape(E, K)
  np.testing.assert_allclose(sol.cost.numpy(), costs[:, 0].numpy(), rtol=1e-12)
  np.testing.assert_allclose(sol.best_cost.numpy(), costs.min(1).values.numpy(), rtol=1e-12)
  assert (swapped - fc(X, rows).reshape(E, K)).abs().min() > 1e-6   # the terrain matters


# ---- which terrain scenes the fused step takes ------------------------------------


def _free(name="base", **kw):
  return dict(parent=-1, joint=TJ.FREE, mass=1.0, inertia=0.01 * np.eye(3), name=name,
              actuated=False, **kw)


def _slider(**kw):
  return dict(parent=0, joint=TJ.PRISMATIC, axis=[0, 0, 1], mass=0.5,
              inertia=0.01 * np.eye(3), name="slider", **kw)


SPHERE = dict(gtype=0, params=[0.05])
ELIGIBILITY = {
    "free root": ([_free()], [dict(body=0, **SPHERE)], None),
    "revolute root": ([dict(_free(), joint=TJ.REVOLUTE)], [dict(body=0, **SPHERE)],
                      "FREE root"),
    "no colliding geom": ([_free()], [], "no colliding pairs"),
    "unlimited prismatic": ([_free(), _slider()], [dict(body=1, **SPHERE)],
                            "unlimited prismatic"),
    "limited prismatic": ([_free(), _slider(q_lo=-0.1, q_hi=0.1)], [dict(body=1, **SPHERE)],
                          None),
}


@pytest.mark.parametrize("case", list(ELIGIBILITY))
def test_fused_step_keeps_the_jax_eligibility(case):
  """make_step_batch_fused takes a terrain scene or raises
  FusedStepUnsupported exactly where the JAX package's _analyze_field does,
  so that fused="auto" picks the same path in both packages."""
  from raisimlib_torch.ops import gpu_step
  from raisimlib_torch.utils import terrain
  from raisimlib_torch.world import World

  bodies, geoms, error = ELIGIBILITY[case]
  world = World(dt=0.002, device="cpu")
  world.add_articulated_system(bodies, name="thing", geoms=geoms)
  world.add_heightmap(terrain.flat(0.0, size=(2.0, 2.0), samples=(5, 5), device="cpu"))
  scene = world.compile()
  if error is None:
    sd = gpu_step.make_step_batch_fused(scene, use_pd=False).sd
    assert [s.kind for s in sd.slots] == ["hm_pt"] and sd.hm.nx == 5
  else:
    with pytest.raises(gpu_step.FusedStepUnsupported, match=error):
      gpu_step.make_step_batch_fused(scene, use_pd=False)


def test_unported_geoms_on_terrain_name_their_roadmap_item():
  """A cylinder and a cone in one world on a heightmap: each has its
  heightmap narrow phase, and the two pair through the support-function
  kernel (ROADMAP.md item 13, now ported): the scene builds with the JAX
  package's pairs and slot count, and its narrow phase runs."""
  import jax.numpy as jnp
  from raisimlib_tpu.ops import collision as jcoll
  from raisimlib_tpu.ops import heightmap as jhm
  from raisimlib_tpu.world import World as JWorld
  from raisimlib_torch.ops import collision as coll
  from raisimlib_torch.ops import dynamics
  from raisimlib_torch.utils import terrain
  from raisimlib_torch.world import World

  scenes = []
  for W, field in ((World, terrain.flat(0.0, size=(2.0, 2.0), samples=(5, 5), device="cpu")),
                   (JWorld, jhm.HeightField(heights=jnp.zeros((5, 5)), center=jnp.zeros(2),
                                            size_x=2.0, size_y=2.0))):
    world = W(dt=0.002, **({"device": "cpu"} if W is World else {}))
    world.add_heightmap(field)
    world.add_cylinder(0.05, 0.1, 1.0, pos=(0.0, 0.0, 0.2))
    world.add_cone(0.05, 0.1, 1.0, pos=(0.5, 0.0, 0.2))
    scenes.append(world.compile())
  ts, js = scenes
  assert ts.pairs == js.pairs
  assert coll.num_contact_slots(ts.geoms, ts.pairs) == jcoll.num_contact_slots(js.geoms, js.pairs)
  s = ts.init_state()
  c = coll.collide(ts.geoms, ts.pairs, dynamics.fk(ts.model, s.q[None]), ts.field)
  assert c.depth.shape == (1, 6 + 4 + 4) and float(c.active[0, 10:].sum()) == 0.0
