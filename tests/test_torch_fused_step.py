"""The fused full step (K1): the port's twin `_fused_plain`, behind
make_step_batch_fused on CPU tensors, against the JAX package.

  * Tiny scenes against JAX's own K1 (pallas_step) in interpret mode, as
    tests/test_pallas_step.py runs it: a cartpole with PD (one step) and a
    sphere on the plane (30 steps), f32, at that file's tolerances.
  * A 2-dof arm with limit rows and a spherical pendulum against JAX's pure
    path, f64 (interpret-mode compiles cost 10-14 s each).
  * ANYmal against JAX's pure path (f32 and f64) and against the port's K2
    path (f64, same cone algorithm).
  * Gradients, the fused modes of make_contact_dyn_batch, and the generated
    CUDA source: deterministic, float32 literals, the twin's operation
    tally, and its body, compiled as host C++, against the twin; the last
    two also for ANYmal on a heightmap (K1c).
  * K1b (a sphere against a sphere, a box or a capsule): the slots of JAX's
    _analyze, the twin against the port's K2 path (static geoms and a
    shared root included), the tally and the host-compiled body.

JAX scenes cross over through convert.scene_from_numpy."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import (flatten_jax_scene, host_matches_twin, host_step, jax_anymal_scene,
                             load_golden, perturbed_states, torch_anymal_scene)

from raisimlib_tpu.models.model import JointType
from raisimlib_tpu.world import World as JWorld


def _port(jscene, dtype):
  from raisimlib_torch import convert

  return convert.scene_from_numpy(*flatten_jax_scene(jscene), device="cpu", dtype=dtype)


def _cartpole(dtype):
  world = JWorld(dt=0.01, dtype=dtype)
  bodies = [
      dict(parent=-1, joint=JointType.PRISMATIC, axis=[1, 0, 0], mass=1.0,
           com=[0, 0, 0], inertia=np.zeros((3, 3)), name="cart", torque_limit=50.0),
      dict(parent=0, joint=JointType.REVOLUTE, axis=[0, 1, 0], mass=0.2,
           com=[0, 0, 0.3], inertia=0.2 * 0.09 * np.eye(3), name="pole",
           actuated=False),
  ]
  world.add_articulated_system(bodies, name="cartpole")
  return world.compile(joint_limits=False).set_pd_gains(10.0, 0.5)


def _sphere(dtype):
  world = JWorld(dt=0.002, dtype=dtype)
  world.add_ground()
  world.add_sphere(0.1, 1.0, pos=(0.0, 0.0, 0.12))
  return world.compile(joint_limits=False)


def _arm(dtype):
  world = JWorld(dt=0.005, dtype=dtype)
  bodies = [
      dict(parent=-1, joint=JointType.REVOLUTE, axis=[0, 1, 0], mass=1.0,
           com=[0, 0, 0.2], inertia=0.04 * np.eye(3), name="link1",
           q_lo=-0.5, q_hi=0.5, torque_limit=20.0),
      dict(parent=0, joint=JointType.REVOLUTE, axis=[0, 1, 0], mass=0.5,
           com=[0, 0, 0.2], inertia=0.02 * np.eye(3), pos=[0, 0, 0.4],
           name="link2", q_lo=-0.3, q_hi=0.3, torque_limit=20.0),
  ]
  world.add_articulated_system(bodies, name="arm")
  return world.compile(joint_limits=True)


def _ball(dtype):
  world = JWorld(dt=0.005, dtype=dtype)
  world.add_articulated_system([dict(parent=-1, joint=JointType.SPHERICAL, mass=1.0,
                                     com=[0.15, 0.0, -0.25], inertia=0.03 * np.eye(3),
                                     name="bob", actuated=False)], name="ball")
  return world.compile(joint_limits=False)


def _inputs(jscene, B, seed, dq, du):
  """Seeded states around the scene's initial q, quaternions renormalised."""
  rng = np.random.RandomState(seed)
  m = jscene.model
  q = np.tile(np.asarray(jscene.init_state().q, np.float64)[None], (B, 1))
  q += dq * rng.randn(*q.shape)
  for b in range(m.nb):
    jt = JointType(m.joint_types[b])
    if jt in (JointType.FREE, JointType.SPHERICAL):
      qa = m.q_adr[b] + (3 if jt == JointType.FREE else 0)
      q[:, qa:qa + 4] /= np.linalg.norm(q[:, qa:qa + 4], axis=1, keepdims=True)
  return q, du * rng.randn(B, m.nv)


def _roll_port(tscene, q, u, tau, pd, n, dtype, use_pd):
  from raisimlib_torch.ops import gpu_step
  from raisimlib_torch.ops.integrator import State

  step = gpu_step.make_step_batch_fused(tscene, use_pd=use_pd)
  t = lambda x: None if x is None else torch.tensor(x, dtype=dtype)   # noqa: E731
  s = State(q=t(q), u=t(u), t=torch.zeros(q.shape[0], dtype=dtype))
  with torch.inference_mode():
    for _ in range(n):
      s = step(s, t(tau), t(pd))
  return s.q.numpy(), s.u.numpy()


def _roll_jax(stepfn, q, u, n, dtype):
  from raisimlib_tpu.ops.integrator import State as JState

  def roll(s):
    return jax.lax.scan(lambda s, _: (stepfn(s), None), s, None, length=n)[0]

  s = JState(q=jnp.asarray(q, dtype), u=jnp.asarray(u, dtype),
             t=jnp.zeros((q.shape[0],), dtype))
  s = jax.jit(roll)(s)
  return np.asarray(s.q), np.asarray(s.u)


# ---- against JAX's K1 in interpret mode -----------------------------------


def test_cartpole_matches_jax_k1():
  """Smooth dynamics (FK, RNEA, CRBA, implicit PD, integration), one step:
  tests/test_pallas_step.py's bounds (2e-6 on q, 2e-4 on u)."""
  from raisimlib_tpu.ops import pallas_step

  js = _cartpole(jnp.float32)
  q, u = _inputs(js, 4, seed=0, dq=0.3, du=0.3)
  tau = np.zeros((4, 2))
  pd = 0.2 * np.random.RandomState(1).randn(4, 2)
  fused = pallas_step.make_step_batch_fused(js)
  qj, uj = _roll_jax(lambda s: fused(s, jnp.asarray(tau, jnp.float32),
                                     jnp.asarray(pd, jnp.float32)), q, u, 1, jnp.float32)
  qt, ut = _roll_port(_port(js, torch.float32), q, u, tau, pd, 1, torch.float32, True)
  np.testing.assert_allclose(qt, qj, atol=2e-6)
  np.testing.assert_allclose(ut, uj, atol=2e-4)


def test_sphere_on_plane_matches_jax_k1():
  """Contact rows and the cone solve, 30 steps of a bouncing/sticking
  sphere: tests/test_pallas_step.py's bounds (5e-4 on q, 5e-3 on u)."""
  from raisimlib_tpu.ops import pallas_step

  js = _sphere(jnp.float32)
  q, u = _inputs(js, 4, seed=0, dq=0.005, du=0.2)
  tau = np.zeros((4, 6))
  fused = pallas_step.make_step_batch_fused(js, use_pd=False)
  qj, uj = _roll_jax(lambda s: fused(s, jnp.asarray(tau, jnp.float32)), q, u, 30,
                     jnp.float32)
  qt, ut = _roll_port(_port(js, torch.float32), q, u, tau, None, 30, torch.float32, False)
  np.testing.assert_allclose(qt, qj, atol=5e-4)
  np.testing.assert_allclose(ut, uj, atol=5e-3)
  assert np.all(qt[:, 2] > 0.09)             # resting on the plane at z ~ r


# ---- against JAX's pure path ------------------------------------------------


@pytest.mark.parametrize("name", ["arm_limits", "spherical"])
def test_small_scenes_match_jax_pure_path(name):
  """Limit rows (a 2-dof arm driven into its limits, 40 steps) and a
  SPHERICAL joint (40 steps), f64 against pipeline.step_batch(
  use_kernel=False). No cone rows, so the algorithms agree exactly and only
  float64 rounding separates them: 1e-9."""
  from raisimlib_tpu.ops import pipeline as jp

  if name == "arm_limits":
    js = _arm(jnp.float64)
    q, u = _inputs(js, 4, seed=0, dq=0.2, du=1.0)
    tau = np.array([[5.0, 3.0], [-5.0, 3.0], [5.0, -3.0], [-5.0, -3.0]])
  else:
    js = _ball(jnp.float64)
    q, u = _inputs(js, 4, seed=0, dq=0.1, du=0.3)
    tau = np.zeros((4, 3))
  qj, uj = _roll_jax(lambda s: jp.step_batch(js, s, jnp.asarray(tau), None,
                                             use_kernel=False), q, u, 40, jnp.float64)
  qt, ut = _roll_port(_port(js, torch.float64), q, u, tau, None, 40, torch.float64, False)
  np.testing.assert_allclose(qt, qj, atol=1e-9)
  np.testing.assert_allclose(ut, uj, atol=1e-9)
  if name == "arm_limits":                   # the limits hold
    assert np.all(np.abs(qt[:, 0]) < 0.55) and np.all(np.abs(qt[:, 1]) < 0.35)


@pytest.fixture(scope="module")
def anymal_inputs():
  g = load_golden()
  q, u = perturbed_states(g, 4, seed=5)
  tgt = np.tile(g["pd_targets"][0], (4, 1))
  return q, u, np.zeros_like(tgt), tgt


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_anymal_matches_jax_pure_path(anymal_inputs, dtype):
  """ANYmal, 3 steps at B = 4 against JAX's pipeline.step_batch(
  use_kernel=False): the twin's slip search (grid + refinements + parabola)
  against the reference's (grid + Newton), at the kernel-vs-pure bounds of
  tests/test_torch_step.py (5e-4 on q, 5e-3 on u)."""
  from raisimlib_tpu.ops import pipeline as jp

  q, u, tau, pd = anymal_inputs
  jd, td = getattr(jnp, dtype), getattr(torch, dtype)
  js = jax_anymal_scene(dtype=jd)
  qj, uj = _roll_jax(lambda s: jp.step_batch(js, s, jnp.asarray(tau, jd), jnp.asarray(pd, jd),
                                             use_kernel=False), q, u, 3, jd)
  qt, ut = _roll_port(torch_anymal_scene(dtype=td), q, u, tau, pd, 3, td, True)
  np.testing.assert_allclose(qt, qj, atol=5e-4, rtol=1e-4)
  np.testing.assert_allclose(ut, uj, atol=5e-3, rtol=1e-3)


def test_anymal_matches_k2_path(anymal_inputs):
  """ANYmal, 3 steps in f64 against the port's pipeline.step_batch (the K2
  twin: the same cone algorithm). Only the assembly differs (recursive CRBA
  and triangular solves against the world-frame congruence and explicit
  inverse factors), so only float64 rounding separates them: 1e-10."""
  from raisimlib_torch.ops import pipeline as tp
  from raisimlib_torch.ops.integrator import State

  q, u, tau, pd = anymal_inputs
  ts = torch_anymal_scene()
  qt, ut = _roll_port(ts, q, u, tau, pd, 3, torch.float64, True)
  s = State(q=torch.tensor(q), u=torch.tensor(u), t=torch.zeros(4, dtype=torch.float64))
  with torch.inference_mode():
    for _ in range(3):
      s = tp.step_batch(ts, s, torch.tensor(tau), torch.tensor(pd))
  np.testing.assert_allclose(qt, s.q.numpy(), atol=1e-10)
  np.testing.assert_allclose(ut, s.u.numpy(), atol=1e-10)


# ---- gradients and the fused modes -------------------------------------------


def test_gradients_equal_step_batch():
  """Through make_step_batch_fused on the CPU the backward differentiates
  pipeline.step_batch: the same gradients w.r.t. q, u, tau and pd (cartpole,
  f64)."""
  from raisimlib_torch.ops import gpu_step
  from raisimlib_torch.ops import pipeline as tp
  from raisimlib_torch.ops.integrator import State

  ts = _port(_cartpole(jnp.float64), torch.float64)
  q, u = _inputs(_cartpole(jnp.float64), 3, seed=2, dq=0.3, du=0.3)
  pd = 0.2 * np.random.RandomState(3).randn(3, 2)
  fused = gpu_step.make_step_batch_fused(ts)
  grads = []
  for stepfn in (lambda s, tau, pd: fused(s, tau, pd),
                 lambda s, tau, pd: tp.step_batch(ts, s, tau, pd)):
    xs = [torch.tensor(x, requires_grad=True) for x in (q, u, np.zeros((3, 2)), pd)]
    out = stepfn(State(q=xs[0], u=xs[1], t=torch.zeros(3, dtype=torch.float64)), xs[2], xs[3])
    loss = (out.q ** 2).sum() + (out.u[:, 1] ** 3).sum()
    grads.append(torch.autograd.grad(loss, xs))
  for gf, gp in zip(*grads):
    np.testing.assert_allclose(gf.numpy(), gp.numpy(), rtol=1e-12, atol=1e-12)


def _ineligible_scene():
  """A box resting on a box: box-box has no K1 slot (nor a port narrow
  phase yet: ROADMAP.md item 13)."""
  world = JWorld(dt=0.002, dtype=jnp.float64)
  world.add_ground()
  world.add_box((0.1, 0.1, 0.1), 1.0, pos=(0.0, 0.0, 0.1), name="a")
  world.add_box((0.1, 0.1, 0.1), 1.0, pos=(0.0, 0.0, 0.3), name="b")
  return _port(world.compile(joint_limits=False), torch.float64)


def test_require_raises_and_auto_warns_on_ineligible_scene(monkeypatch):
  from raisimlib_torch.mpc import state_map
  from raisimlib_torch.ops import gpu_step

  ts = _ineligible_scene()
  with pytest.raises(gpu_step.FusedStepUnsupported, match="ROADMAP.md item 13"):
    state_map.make_contact_dyn_batch(ts, 0.002, 1, use_pd=False, fused="require")
  with pytest.raises(ValueError, match="fused="):
    state_map.make_contact_dyn_batch(ts, 0.002, 1, use_pd=False, fused="always")
  # "auto" looks at K1 only for a scene on the card: pretend this one is
  monkeypatch.setattr(state_map, "_on_card", lambda scene: True)
  calls = []
  monkeypatch.setattr(state_map.pipeline, "step_batch",
                      lambda scene, s, *a, **k: calls.append(1) or s)
  with pytest.warns(UserWarning, match="does not cover this scene"):
    dyn_b, nx, nu = state_map.make_contact_dyn_batch(ts, 0.002, 1, use_pd=False)
  dyn_b(torch.zeros((2, nx), dtype=torch.float64),
        torch.zeros((2, nu), dtype=torch.float64), 0)
  assert calls == [1]                           # the K2 path took the step


def test_mppi_require_matches_never():
  """One MPPI update of a small population on ANYmal (f64): the K1 twin and
  the K2 twin agree to float64 rounding, amplified by the softmax weights
  (1/temperature): 1e-8."""
  from raisimlib_torch.mpc import mppi, state_map
  from raisimlib_torch.ops.spatial import quat_box_minus

  g = load_golden()
  ts = torch_anymal_scene()
  q, u = perturbed_states(g, 1, seed=6)
  x0 = torch.tensor(np.concatenate([q, u], 1))
  q_st = torch.tensor(g["pd_targets"][0, 6:])
  ident = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=torch.float64)
  z0 = float(g["q0"][2])

  def rc(X, A, t):
    return (40.0 * (X[:, 2] - z0) ** 2 + 10.0 * (quat_box_minus(X[:, 3:7], ident) ** 2).sum(1)
            + ((A - q_st) ** 2).sum(1)) * 0.01

  def fc(X):
    return 200.0 * (X[:, 2] - z0) ** 2

  Us = q_st.expand(1, 2, 12).clone()
  eps = 0.1 * torch.tensor(np.random.default_rng(7).standard_normal((1, 4, 2, 12)))
  cfg = mppi.MPPIConfig(n_samples=4, sigma=0.1, temperature=0.3)
  sols = []
  for mode in ("require", "never"):
    dyn_b, _, _ = state_map.make_contact_dyn_batch(ts, 0.0025, 1, fused=mode)
    with torch.inference_mode():
      sols.append(mppi.mppi_step_batch(dyn_b, rc, fc, x0, Us, config=cfg, eps_white=eps))
  for a, b in zip(sols[0], sols[1]):
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-8, atol=1e-8)
  assert (sols[0].U - Us).abs().max() > 1e-4


# ---- the generated CUDA source --------------------------------------------------


@pytest.fixture(scope="module")
def anymal_sd():
  from raisimlib_torch.ops import gpu_step
  from raisimlib_torch.ops import pipeline as tp

  return gpu_step._analyze(torch_anymal_scene(dtype=torch.float32), tp.StepConfig(), True)


def test_kernel_source_is_deterministic_float32(anymal_sd):
  from raisimlib_torch.ops import gpu_step

  src, ops, loads = gpu_step.kernel_source(anymal_sd)
  assert (src, ops, loads) == gpu_step.kernel_source(anymal_sd) and loads == 0
  body = src.split("fs_body(", 1)[1]
  # every floating literal carries the f suffix: a bare double literal would
  # promote its whole expression to double
  lits = re.findall(r"(?<![\w.])(\d+\.\d*(?:e[+-]?\d+)?|\d+e[+-]?\d+)(f?)", body)
  assert lits and all(suffix == "f" for _, suffix in lits), \
      [x for x, s in lits if s != "f"][:5]
  for fast in ("__sinf", "__cosf", "__expf", "__fdividef", "double"):
    assert fast not in body
  assert "#pragma unroll 1" in body and "rsl::cone_solve_lanes(" in body


def test_kernel_tally_equals_twin(anymal_sd):
  """The operations the kernel source runs per world (loop bodies times trip
  counts) are the ones the twin runs: the bound in chip_smoke.py is taken
  from this tally."""
  from raisimlib_torch.ops import gpu_step

  _, ops, _ = gpu_step.kernel_source(anymal_sd)
  z = lambda n: torch.zeros((1, n))   # noqa: E731
  q = torch.tensor(load_golden()["q0"][None], dtype=torch.float32)
  with torch.inference_mode():
    *_, twin_ops = gpu_step._fused_plain(anymal_sd, q, z(18), z(18), z(18), return_ops=True)
  assert ops == twin_ops
  assert 2e5 < ops < 6e5


def test_launch_refuses_cpu_tensors(anymal_sd):
  """The kernel wrapper never runs the twin: CPU tensors raise."""
  from raisimlib_torch.ops import gpu_step

  kern = gpu_step.FusedKernel(anymal_sd)
  x = torch.zeros((2, 18))
  with pytest.raises(ValueError, match="is on cpu"):
    kern.launch(torch.zeros((2, 19)), x, x, x)


@pytest.fixture(scope="module")
def trot_sd():
  """ANYmal over the trot golden's heightmap (K1c: 12 "hm_pt" slots), f32."""
  from raisimlib_torch.models import anymal
  from raisimlib_torch.models.urdf import load_urdf
  from raisimlib_torch.ops import gpu_step
  from raisimlib_torch.ops import pipeline as tp
  from raisimlib_torch.utils import terrain
  from raisimlib_torch.world import World

  g = load_golden("anymal_trot_heightmap.npz")
  bodies, geoms, _ = load_urdf(anymal.anymal_urdf())
  world = World(dt=float(g["dt"]), dtype=torch.float32, device="cpu")
  world.add_articulated_system(bodies, name="anymal", geoms=geoms)
  world.add_heightmap(terrain.flat(0.0, size=(12.0, 6.0), samples=(48, 24), device="cpu"))
  scene = world.compile().set_pd_gains(float(g["kp"]), float(g["kd"]))
  return gpu_step._analyze(scene, tp.StepConfig(), True), g


def test_terrain_kernel_tally_equals_twin(trot_sd):
  """K1c's source and its twin tally the same operations and height loads
  per world: 4 foot spheres x 17 samples and 8 corners x 1, 4 heights
  each."""
  from raisimlib_torch.ops import gpu_step

  sd, g = trot_sd
  _, ops, loads = gpu_step.kernel_source(sd)
  q = torch.tensor(g["q0"][None], dtype=torch.float32)
  z = torch.zeros((1, 18))
  with torch.inference_mode():
    K = gpu_step._TorchOps(1, torch.float32, "cpu", torch.tensor(g["heights"][None],
                                                                 dtype=torch.float32))
    cols = lambda x, n: [gpu_step._Val(K, x[:, k]) for k in range(n)]   # noqa: E731
    gpu_step._emit_step(sd, K, cols(q, 19), cols(z, 18), cols(z, 18), cols(z, 18))
  assert (ops, loads) == (K.ops, K.loads)
  assert loads == 4 * (4 * 17 + 8)


def test_kernel_body_compiled_on_host_matches_twin(anymal_sd, tmp_path):
  """The generated body compiled as host C++ and run on the CPU, against the
  twin on 64 ANYmal worlds: the same operations in the same order, so only
  the host's libm (sinf, cosf) and rsqrt = 1/sqrt separate them, by an ulp
  that the Gauss-Seidel sweeps can amplify (see torch_port_util.host_matches_twin)."""
  g = load_golden()
  q, u = perturbed_states(g, 64, seed=8)
  host_matches_twin(anymal_sd, host_step(anymal_sd, tmp_path), q, u,
                     np.tile(g["pd_targets"][0], (64, 1)))


def test_terrain_kernel_body_compiled_on_host_matches_twin(trot_sd, tmp_path):
  """K1c's body (the heightmap probe and its runtime frames) compiled as host
  C++, against the twin on 64 ANYmal worlds around the trot golden's start,
  each on its own terrain: the golden's heights plus 2 cm of noise, so that
  the worlds read their own fields (stride nx ny)."""
  sd, g = trot_sd
  rng = np.random.RandomState(9)
  q, u = perturbed_states(g, 64, seed=9)
  hts = g["heights"][None] + 0.02 * rng.randn(64, 48, 24)
  host_matches_twin(sd, host_step(sd, tmp_path), q, u,
                     np.tile(g["pd_targets"][0], (64, 1)), hts)


# ---- K1b: a sphere against a sphere, a box or a capsule ------------------------


def _chip_smoke():
  import importlib.util
  import os

  path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "chip_smoke.py")
  spec = importlib.util.spec_from_file_location("chip_smoke", path)
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod


def _loose_scene(name, dtype):
  """chip_smoke.py's three K1b scenes; a sphere on a static sphere ("ss"
  with body_a = -1); a sphere on a grandchild link touching its own root's
  box ("sb" whose two sides share the root's six dofs)."""
  from raisimlib_torch.models.model import JointType as TJ
  from raisimlib_torch.ops import collision as coll
  from raisimlib_torch.world import World

  cs = _chip_smoke()
  make = {"stack": cs.stack_scene, "spheres_capsule": cs.spheres_capsule_scene,
              "static_box": cs.static_box_scene}
  if name in make:
    return make[name](torch, device="cpu", dtype=dtype)
  if name == "static_sphere":
    w = World(dt=0.002, dtype=dtype, device="cpu")
    w.add_ground()
    # static world spheres have no add_* call (nor in the JAX package): the
    # geom goes in directly, before the dynamic sphere, so it is the pair's A
    w._geoms.append(coll.GeomSpec(-1, coll.GEOM_SPHERE, np.array([0.1, 0.0, 0.0, 0.0]),
                                  np.array([0.0, 0.0, 0.1]), np.eye(3), 0))
    w.add_sphere(0.1, 1.0, pos=(0.03, 0.0, 0.3))
    return w.compile(joint_limits=False)
  w = World(dt=0.002, dtype=dtype, self_collision=True, device="cpu")
  w.add_ground()
  link = dict(joint=TJ.REVOLUTE, axis=[0, 1, 0], mass=0.3, inertia=0.002 * np.eye(3),
              com=[0.05, 0.0, 0.0], actuated=False)
  w.add_articulated_system(
      [dict(parent=-1, joint=TJ.FREE, mass=2.0, inertia=0.02 * np.eye(3), name="base",
            actuated=False, q_init=[0, 0, 0.2, 1, 0, 0, 0]),
       dict(link, parent=0, pos=[0.1, 0.0, 0.15], name="l1"),
       dict(link, parent=1, pos=[0.1, 0.0, 0.0], name="l2")],
      name="arm", geoms=[dict(body=0, gtype=coll.GEOM_BOX, params=[0.15, 0.1, 0.1]),
                         dict(body=2, gtype=coll.GEOM_SPHERE, params=[0.05],
                              offset_pos=[-0.1, 0.0, -0.05])])
  return w.compile(joint_limits=False)


LOOSE = ["stack", "spheres_capsule", "static_box", "static_sphere", "shared_root"]
# states with every sphere pair in contact: the stack settled (the golden's
# step 300) with its box kicked; chip_smoke.py's touching states of its other
# two scenes; the sphere on the static sphere; the arm as built (its sphere
# on the box's top face)
_CONTACT_Q = dict(
    _chip_smoke().CONTACT_Q,
    static_sphere=[0.03, 0.0, 0.1 + float(np.sqrt(0.04 - 0.0009)) - 0.001, 1, 0, 0, 0])


def _contact_states(scene, name, B, seed, dq=1e-3, du=1e-2):
  m = scene.model
  if name == "stack":
    g = load_golden("sphere_box_stack.npz")
    q0, u0 = g["q"][300], g["u"][300] + 0.3 * np.eye(12)[3]
  else:
    q0 = np.asarray(_CONTACT_Q.get(name, m.q_init.numpy()), np.float64)
    u0 = np.zeros(m.nv)
  rng = np.random.RandomState(seed)
  q = np.tile(q0[None], (B, 1)) + dq * rng.randn(B, m.nq)
  for b in range(m.nb):
    if JointType(m.joint_types[b]) == JointType.FREE:
      qa = m.q_adr[b] + 3
      q[:, qa:qa + 4] /= np.linalg.norm(q[:, qa:qa + 4], axis=1, keepdims=True)
  return q, u0[None] + du * rng.randn(B, m.nv)


@pytest.mark.parametrize("name", ["stack", "spheres_capsule"])
def test_k1b_slots_match_jax(name):
  """The JAX package's own K1b scenes (tests/test_pallas_step.py,
  TestRuntimeFramePairs), carried over by convert.scene_from_numpy: the
  port's _analyze emits JAX's slots, field for field and in pair order."""
  from raisimlib_tpu.ops import pallas_step
  from raisimlib_tpu.ops import pipeline as jp
  from raisimlib_torch.ops import gpu_step
  from raisimlib_torch.ops import pipeline as tp

  world = JWorld(dt=0.002, dtype=jnp.float64)
  world.add_ground()
  if name == "stack":
    world.add_box((0.1, 0.1, 0.1), 2.0, pos=(0.0, 0.0, 0.1))
    world.add_sphere(0.08, 1.0, pos=(0.02, 0.0, 0.29))
    kinds = ["plane_pt"] * 9 + ["sb"]
  else:
    world.add_sphere(0.1, 1.0, pos=(0.0, 0.0, 0.11), name="a")
    world.add_sphere(0.1, 1.0, pos=(0.12, 0.0, 0.28), name="b")
    world.add_capsule(0.06, 0.15, 0.5, pos=(1.0, 0.0, 0.07), name="c")
    kinds = ["plane_pt"] * 4 + ["sc"] * 2 + ["ss"]
  js = world.compile(joint_limits=False)
  jslots = pallas_step._analyze(js, jp.StepConfig(), use_pd=False).slots
  tslots = gpu_step._analyze(_port(js, torch.float64), tp.StepConfig(), False).slots
  assert sorted(s.kind for s in tslots) == kinds
  assert len(tslots) == len(jslots)
  for ts_, js_ in zip(tslots, jslots):
    for f in gpu_step._Slot._fields:
      assert getattr(ts_, f) == getattr(js_, f), (f, getattr(ts_, f), getattr(js_, f))


@pytest.mark.parametrize("name", LOOSE)
def test_k1b_twin_matches_k2_path(name):
  """The twin on the K1b scenes, 2 steps of 4 worlds with every sphere pair
  in contact, against the port's K2 path (pipeline.step_batch, the same cone
  algorithm), f64: only the assembly differs, so float64 rounding alone
  separates them, 1e-10. The static cases are the world-frame pose of body
  -1 in phase E; the arm's sphere-box Jacobian drops the shared root dofs."""
  from raisimlib_torch.ops import collision as coll
  from raisimlib_torch.ops import dynamics
  from raisimlib_torch.ops import gpu_step
  from raisimlib_torch.ops import pipeline as tp
  from raisimlib_torch.ops.integrator import State

  ts = _loose_scene(name, torch.float64)
  step = gpu_step.make_step_batch_fused(ts, use_pd=False)
  k1b = [i for i, s in enumerate(step.sd.slots) if s.kind in ("ss", "sb", "sc")]
  assert k1b
  q, u = _contact_states(ts, name, 4, seed=14)
  kin = dynamics.fk(ts.model, torch.tensor(q))
  active = coll.collide(ts.geoms, ts.pairs, kin).active[:, k1b]
  assert bool((active.sum(0) > 0).all()), active       # every sphere pair touches
  if name == "shared_root":
    (slot,) = [step.sd.slots[i] for i in k1b]
    assert (slot.body_a, slot.body_b) == (2, 0)
  tau = torch.zeros((4, ts.model.nv), dtype=torch.float64)
  s1 = s2 = State(q=torch.tensor(q), u=torch.tensor(u), t=torch.zeros(4, dtype=torch.float64))
  with torch.inference_mode():
    for _ in range(2):
      s1 = step(s1, tau)
      s2 = tp.step_batch(ts, s2, tau)
  np.testing.assert_allclose(s1.q.numpy(), s2.q.numpy(), rtol=0, atol=1e-10)
  np.testing.assert_allclose(s1.u.numpy(), s2.u.numpy(), rtol=0, atol=1e-10)


def test_k1b_tally_equals_twin():
  """The K1b sources (the stack, and the spheres with the capsule) tally
  the operations their twins run."""
  from raisimlib_torch.ops import gpu_step
  from raisimlib_torch.ops import pipeline as tp

  for name in ("stack", "spheres_capsule"):
    ts = _loose_scene(name, torch.float32)
    sd = gpu_step._analyze(ts, tp.StepConfig(), False)
    _, ops, loads = gpu_step.kernel_source(sd)
    q, u = _contact_states(ts, name, 1, seed=15)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)   # noqa: E731
    with torch.inference_mode():
      *_, twin_ops = gpu_step._fused_plain(sd, f32(q), f32(u), torch.zeros((1, ts.model.nv)),
                                           return_ops=True)
    assert (ops, loads) == (twin_ops, 0)
    assert 1e5 < ops < 4e5


@pytest.mark.parametrize("name", ["stack", "spheres_capsule", "static_box"])
def test_k1b_body_compiled_on_host_matches_twin(name, tmp_path):
  """K1b's body compiled as host C++ against the twin on 32 worlds with the
  sphere pairs in contact, at the tiers of host_matches_twin; the median
  world within 5e-6 on u: each sphere pair's runtime frame takes an rsqrt,
  which the host computes as 1/sqrt, an ulp off, and the sliding box's slip
  searches amplify it more often than ANYmal's static-frame contacts do."""
  from raisimlib_torch.ops import gpu_step
  from raisimlib_torch.ops import pipeline as tp

  ts = _loose_scene(name, torch.float32)
  sd = gpu_step._analyze(ts, tp.StepConfig(), False)
  q, u = _contact_states(ts, name, 32, seed=16)
  host_matches_twin(sd, host_step(sd, tmp_path), q, u, np.zeros((32, ts.model.nv)),
                     median_du=5e-6)
