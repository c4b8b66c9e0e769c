"""K1c's last three slot kinds (the fused step, ops/gpu_step.py) against the
JAX package and against the port's own twin, for a loose cylinder
("hm_cylpt"), cone ("hm_conept") and 32-vertex convex rock ("hm_mesh") on a
heightmap, chip_smoke.py's debris bodies:

  * _analyze emits JAX's slots (kind, order, local, he, b_pos, b_rot, mu,
    ...) and mesh tables (host numpy: no kernel runs);
  * the float32 twin (make_step_batch_fused on CPU tensors) against JAX's
    float64 pure path over 4 steps of dropped bodies (5e-4 on q, 5e-3 on u:
    the kernel-vs-pure bounds of tests/test_torch_step.py);
  * the twin's operation and height-load tally equals kernel_source's;
  * the generated body compiled as host C++ against the twin, at the card's
    tiers (torch_port_util.host_matches_twin), the only CPU check of the
    kernel's text;
  * the fused step's gradient is pipeline.step_batch's (the cylinder);
  * make_contact_dyn_batch(fused="require") takes the three scenes;
  * a cylinder on the ground plane stays outside K1, as in the JAX package.

The scenes are built in JAX and carried across with convert.scene_from_numpy;
JAX runs its pure path (step_batch(use_kernel=False)), never a Pallas kernel."""

import numpy as np
import pytest
import torch

from torch_port_util import (debris_drop_states, debris_max_depth, host_matches_twin, host_step,
                             jax_debris_rollout, jax_debris_scene, port_scene)

B, STEPS = 4, 4
SHAPES = ("cylinder", "cone", "mesh")
KINDS = {"cylinder": ["hm_cylpt"] * 6, "cone": ["hm_conept"] * 4, "mesh": ["hm_mesh"] * 4}
SEEDS = {"cylinder": 31, "cone": 32, "mesh": 33}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
  """One intra-op thread for this module: its tensors are a few worlds
  wide, and the test workers share the machine's cores."""
  n = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scenes():
  """Per body: the JAX f64 scene and the port's f64 and f32 scenes."""
  out = {}
  for name in SHAPES:
    js = jax_debris_scene(name)
    out[name] = (js, port_scene(js), port_scene(js, torch.float32))
  return out


def _sd(scene):
  from raisimlib_torch.ops import gpu_step
  from raisimlib_torch.ops import pipeline as tp

  return gpu_step._analyze(scene, tp.StepConfig(), False)


@pytest.mark.parametrize("name", SHAPES)
def test_slots_match_jax(scenes, name):
  from raisimlib_tpu.ops import pallas_step
  from raisimlib_tpu.ops import pipeline as jp
  from raisimlib_torch.ops import gpu_step

  js, ts, _ = scenes[name]
  jsd = pallas_step._analyze(js, jp.StepConfig(), use_pd=False)
  tsd = _sd(ts)
  assert [s.kind for s in tsd.slots] == KINDS[name]
  assert len(tsd.slots) == len(jsd.slots)
  for ts_, js_ in zip(tsd.slots, jsd.slots):
    for f in gpu_step._Slot._fields:
      assert getattr(ts_, f) == getattr(js_, f), (f, getattr(ts_, f), getattr(js_, f))
  assert tsd.hm_meshes == jsd.hm_meshes
  assert len(tsd.hm_meshes) == (name == "mesh") and all(vc == 32 for *_, vc in tsd.hm_meshes)


@pytest.mark.parametrize("name", SHAPES)
def test_twin_matches_jax_pure_path(scenes, name):
  """4 dropped bodies, 4 steps: the float32 twin against JAX's float64 run."""
  from raisimlib_torch.ops import gpu_step
  from raisimlib_torch.ops.integrator import State

  js, ts64, ts = scenes[name]
  hts, q, u = debris_drop_states(ts64, B, SEEDS[name])
  step = gpu_step.make_step_batch_fused(ts, use_pd=False)
  f32 = dict(dtype=torch.float32)
  h = torch.tensor(hts, **f32)
  s = State(q=torch.tensor(q, **f32), u=torch.tensor(u, **f32), t=torch.zeros(B, **f32))
  depth = 0.0
  with torch.inference_mode():
    for _ in range(STEPS):
      s = step(s, torch.zeros((B, 6), **f32), field_heights=h)
      depth = max(depth, debris_max_depth(ts, s.q, h))
  qj, uj = jax_debris_rollout(js, hts, q, u, STEPS)
  assert depth > 1e-3
  np.testing.assert_allclose(s.q.numpy(), qj, atol=5e-4, rtol=1e-4)
  np.testing.assert_allclose(s.u.numpy(), uj, atol=5e-3, rtol=1e-3)


def test_tally_equals_twin(scenes):
  """kernel_source's operations and height loads per world are the twin's:
  a cylinder probes 6 points, a cone 4 and the rock its 32 vertices, 4
  heights each."""
  from raisimlib_torch.ops import gpu_step

  for name, probes in (("cylinder", 6), ("cone", 4), ("mesh", 32)):
    _, ts64, ts = scenes[name]
    sd = _sd(ts)
    _, ops, loads = gpu_step.kernel_source(sd)
    hts, q, u = debris_drop_states(ts64, 1, SEEDS[name])
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)   # noqa: E731
    with torch.inference_mode():
      K = gpu_step._TorchOps(1, torch.float32, "cpu", f32(hts))
      cols = lambda x, n: [gpu_step._Val(K, x[:, k]) for k in range(n)]   # noqa: E731
      gpu_step._emit_step(sd, K, cols(f32(q), 7), cols(f32(u), 6), cols(torch.zeros(1, 6), 6),
                          None)
    assert (ops, loads) == (K.ops, K.loads)
    assert loads == 4 * probes


@pytest.mark.parametrize("name", SHAPES)
def test_body_compiled_on_host_matches_twin(scenes, name, tmp_path):
  """The generated body as host C++ against the twin on 32 worlds in
  contact (the host body's own 20 steps after a drop 1-3 mm over their own
  terrains), the median world within 5e-6 on u: each probe's runtime frame
  takes an rsqrt, which the host computes as 1/sqrt, an ulp off (see the
  K1b case)."""
  _, ts64, ts = scenes[name]
  sd = _sd(ts)
  host = host_step(sd, tmp_path)
  hts, q, u = debris_drop_states(ts64, 32, SEEDS[name] + 10)
  h = np.ascontiguousarray(hts, np.float32)
  q, u = (np.ascontiguousarray(x, np.float32) for x in (q, u))
  zeros = np.zeros_like(u)
  for _ in range(20):
    qo, uo = np.zeros_like(q), np.zeros_like(u)
    host(q.ctypes.data, u.ctypes.data, zeros.ctypes.data, zeros.ctypes.data, h.ctypes.data,
         h[0].size, qo.ctypes.data, uo.ctypes.data, 32)
    q, u = qo, uo
  assert debris_max_depth(ts, torch.tensor(q), torch.tensor(h)) > 1e-4
  host_matches_twin(sd, host, q, u, np.zeros((32, 6)), hts, median_du=5e-6)


def test_fused_gradient_equals_step_batch(scenes):
  """The cylinder: the fused step's gradient (w.r.t. q, u and the heights)
  is pipeline.step_batch's with the step's heights, two sweeps."""
  from raisimlib_torch.ops import contact, gpu_step, pipeline
  from raisimlib_torch.ops.integrator import State

  _, ts, _ = scenes["cylinder"]
  hts, q, u = debris_drop_states(ts, B, SEEDS["cylinder"])
  q[:, 2] -= 0.004                                # start in contact
  cfg = pipeline.StepConfig(solver=contact.SolverConfig(sweeps=2))
  fused = gpu_step.make_step_batch_fused(ts, cfg, use_pd=False)
  tau = torch.zeros((B, 6), dtype=torch.float64)
  grads = []
  for stepfn in (lambda s, h: fused(s, tau, field_heights=h),
                 lambda s, h: pipeline.step_batch(ts, s, tau, config=cfg, field_heights=h)):
    xs = [torch.tensor(x, requires_grad=True) for x in (q, u, hts)]
    out = stepfn(State(q=xs[0], u=xs[1], t=torch.zeros(B, dtype=torch.float64)), xs[2])
    loss = (out.q[:, :3] ** 2).sum() + (out.u ** 2).sum()
    grads.append(torch.autograd.grad(loss, xs))
  for gf, gp in zip(*grads):
    np.testing.assert_allclose(gf.numpy(), gp.numpy(), rtol=1e-12, atol=1e-12)
  assert float(grads[0][2].abs().max()) > 0       # the terrain is in the gradient


def test_contact_dyn_batch_requires_and_takes_the_shapes(scenes):
  """make_contact_dyn_batch(fused="require") builds K1 for each body (on the
  CPU its twin): two substeps equal two fused steps, and stay within the
  kernel-vs-pure bounds of the K2 path (fused="never")."""
  from raisimlib_torch.mpc import state_map
  from raisimlib_torch.ops import gpu_step
  from raisimlib_torch.ops.integrator import State

  for name in SHAPES:
    _, ts64, ts = scenes[name]
    hts, q, u = debris_drop_states(ts64, B, SEEDS[name])
    f32 = dict(dtype=torch.float32)
    X = torch.tensor(np.concatenate([q, u], 1), **f32)
    h = torch.tensor(hts, **f32)
    dyn_k1, nx, nu = state_map.make_contact_dyn_batch(ts, 0.004, 2, use_pd=False,
                                                      fused="require")
    dyn_k2, _, _ = state_map.make_contact_dyn_batch(ts, 0.004, 2, use_pd=False, fused="never")
    assert (nx, nu) == (13, 0)
    step = gpu_step.make_step_batch_fused(ts, use_pd=False)
    A = torch.zeros((B, 0), **f32)
    with torch.inference_mode():
      x1, x2 = dyn_k1(X, A, 0, h), dyn_k2(X, A, 0, h)
      s = State(q=X[:, :7], u=X[:, 7:], t=torch.zeros(B, **f32))
      for _ in range(2):
        s = step(s, torch.zeros((B, 6), **f32), field_heights=h)
    assert torch.equal(x1, torch.cat([s.q, s.u], 1))
    np.testing.assert_allclose(x1[:, :7].numpy(), x2[:, :7].numpy(), atol=5e-4, rtol=1e-4)
    np.testing.assert_allclose(x1[:, 7:].numpy(), x2[:, 7:].numpy(), atol=5e-3, rtol=1e-3)


def test_analyze_refuses_a_cylinder_on_the_ground_plane():
  """Cylinders, cones and meshes against the plane run on the K2 path only:
  JAX's _analyze refuses them ("geom type 5 vs plane"), and the port's
  does too."""
  import jax.numpy as jnp

  from raisimlib_tpu.ops import pallas_step
  from raisimlib_tpu.ops import pipeline as jp
  from raisimlib_tpu.world import World as JWorld
  from raisimlib_torch.ops import gpu_step

  world = JWorld(dt=0.002, dtype=jnp.float64)
  world.add_ground()
  world.add_cylinder(0.1, 0.15, 1.0, pos=(0.0, 0.0, 0.2))
  js = world.compile(joint_limits=False)
  with pytest.raises(pallas_step.FusedStepUnsupported, match="vs plane"):
    pallas_step._analyze(js, jp.StepConfig(), use_pd=False)
  with pytest.raises(gpu_step.FusedStepUnsupported, match="cylinder vs plane"):
    _sd(port_scene(js))
