"""Atlas (BASELINE config 5) in the port against the JAX package:

  * models/atlas.py's URDF and standing pose are the JAX module's;
  * gpu_step._analyze gives JAX's 32 plane_pt slots (the 8 corners of the
    pelvis, torso and two feet boxes) and 23 limit rows, field for field and
    in order; a block of 4 worlds holds 75,584 bytes of shared memory;
  * tests/goldens/atlas_settle.npz through Scene.step in float32, under the
    Atlas gate of utils/parity.py;
  * pipeline.step_batch in f64 at B = 2 against JAX's
    step_batch(use_kernel=False): dq <= 1e-6, du <= 1e-4 (the two run
    different solves: the port's matrix-free one, JAX's reference);
  * K1's twin against the K2 path in float32 over 3 steps, within 1e-4;
  * the generated body as host C++: 1 lane against 8, bitwise, and against
    the twin at the card's tiers.

The scenes come from each package's scenario loader (atlas_batch)."""

import numpy as np
import pytest
import torch

from torch_port_util import host_matches_twin, host_step, load_golden
from torch_port_util import one_thread  # noqa: F401  (a module fixture)

B = 2


@pytest.fixture(scope="module")
def golden():
  return load_golden("atlas_settle.npz")


@pytest.fixture(scope="module")
def jax_scene():
  """JAX's Atlas scene in float64, built once (its jitted step is slow to
  compile)."""
  import jax.numpy as jnp
  from raisimlib_tpu import scenarios

  return scenarios.build_scene(scenarios.load("atlas_batch"), dtype=jnp.float64)[0]


def _port_scene(dtype):
  from raisimlib_torch import scenarios

  return scenarios.build_scene(scenarios.load("atlas_batch"), dtype=dtype, device="cpu")[0]


def _states(g, n, seed, dtype):
  """n states around the golden's start, N(0, 1e-3) on q (quaternion
  renormalised) and N(0, 1e-2) on u."""
  from raisimlib_torch.ops.integrator import State

  rng = np.random.RandomState(seed)
  q = np.tile(g["q0"], (n, 1)) + 1e-3 * rng.randn(n, g["q0"].size)
  q[:, 3:7] /= np.linalg.norm(q[:, 3:7], axis=1, keepdims=True)
  u = np.tile(g["u0"], (n, 1)) + 1e-2 * rng.randn(n, g["u0"].size)
  pd = np.tile(g["pd_targets"][0], (n, 1))
  f = dict(dtype=dtype)
  return (State(q=torch.tensor(q, **f), u=torch.tensor(u, **f), t=torch.zeros(n, **f)),
          torch.tensor(pd, **f))


def test_urdf_and_standing_q_match_jax():
  from raisimlib_torch.models import atlas
  from raisimlib_torch.models.urdf import load_urdf
  from raisimlib_tpu.models import atlas as jatlas
  from raisimlib_tpu.models.urdf import load_urdf as jload_urdf

  assert atlas.atlas_urdf() == jatlas.atlas_urdf()
  assert atlas.JOINT_ORDER == jatlas.JOINT_ORDER
  jmap = load_urdf(atlas.atlas_urdf())[2]
  assert jmap == jload_urdf(jatlas.atlas_urdf())[2] and len(jmap) == 23
  np.testing.assert_array_equal(atlas.standing_q(jmap), jatlas.standing_q(jmap))
  np.testing.assert_array_equal(atlas.standing_q(), jatlas.standing_q())
  np.testing.assert_array_equal(atlas.standing_q(base_z=0.9), jatlas.standing_q(base_z=0.9))


def test_analyze_matches_jax(jax_scene):
  """32 plane_pt slots, 8 on each of 4 bodies (pelvis, torso, feet), and 23
  limit rows: JAX's, field for field and in order."""
  from raisimlib_torch.ops import gpu_step
  from raisimlib_torch.ops import pipeline as tp
  from raisimlib_tpu.ops import pallas_step
  from raisimlib_tpu.ops import pipeline as jp

  ts = _port_scene(torch.float64)
  tsd = gpu_step._analyze(ts, tp.StepConfig(), True)
  jsd = pallas_step._analyze(jax_scene, jp.StepConfig(), use_pd=True)
  assert (tsd.nq, tsd.nv, len(tsd.slots), len(tsd.limits)) == (30, 29, 32, 23)
  assert {s.kind for s in tsd.slots} == {"plane_pt"}
  names = ts.model.body_names
  assert sorted({names[s.body_a] for s in tsd.slots}) == ["l_foot", "pelvis", "r_foot", "utorso"]
  assert len(tsd.slots) == len(jsd.slots) and len(tsd.limits) == len(jsd.limits)
  for ts_, js_ in zip(tsd.slots, jsd.slots):
    for f in gpu_step._Slot._fields:
      assert getattr(ts_, f) == getattr(js_, f), (f, getattr(ts_, f), getattr(js_, f))
  for tl, jl in zip(tsd.limits, jsd.limits):
    assert tuple(tl) == tuple(jl)


def test_block_shared_memory_and_register_cap():
  """A block of 4 worlds holds 75,584 bytes of shared memory (18,896 a
  world), so 3 blocks fit an SM and the register cap stays off."""
  from raisimlib_torch.ops import gpu_step

  sd = gpu_step.make_step_batch_fused(_port_scene(torch.float32)).sd
  assert gpu_step.smem_bytes(sd) == 75584
  assert gpu_step.min_blocks(sd) == 1


def test_golden_through_scene_step(golden):
  """tests/goldens/atlas_settle.npz, 50 steps of Scene.step in float32 with
  the golden's gains, under the Atlas gate (torques within 0.3 N m, the
  base within 2e-3 m)."""
  from raisimlib_torch.ops.integrator import State
  from raisimlib_torch.utils import parity

  g = golden
  scene = _port_scene(torch.float32).set_pd_gains(torch.tensor(g["kp"]), torch.tensor(g["kd"]))
  s = State(q=torch.tensor(g["q0"], dtype=torch.float32),
            u=torch.tensor(g["u0"], dtype=torch.float32), t=torch.tensor(0.0))
  qs, us = [], []
  with torch.inference_mode():
    for tgt in g["pd_targets"]:
      s = scene.step(s, pd_target=torch.tensor(tgt, dtype=torch.float32))
      qs.append(s.q.numpy())
      us.append(s.u.numpy())
  assert parity.atlas_gate_failures(np.stack(qs), np.stack(us), g) == []
  dtau, _ = parity.atlas_deviation(np.stack(qs), np.stack(us), g)
  assert dtau.max() > 0.0


def test_step_batch_matches_jax_f64(jax_scene, golden):
  """One f64 step at B = 2: the port's pipeline.step_batch (its solve is the
  K2 twin on the CPU) against JAX's step_batch(use_kernel=False)."""
  import jax
  import jax.numpy as jnp
  from raisimlib_tpu.ops import pipeline as jp
  from raisimlib_tpu.ops.integrator import State as JState

  s, pd = _states(golden, B, 3, torch.float64)
  js = JState(q=jnp.asarray(s.q.numpy()), u=jnp.asarray(s.u.numpy()), t=jnp.zeros(B))
  jout = jax.jit(lambda st, p: jp.step_batch(jax_scene, st, jnp.zeros((B, 29)), p,
                                             use_kernel=False))(js, jnp.asarray(pd.numpy()))
  with torch.inference_mode():
    tout = _port_scene(torch.float64).step_batch(s, torch.zeros_like(pd), pd)
  assert np.abs(tout.q.numpy() - np.asarray(jout.q)).max() <= 1e-6
  assert np.abs(tout.u.numpy() - np.asarray(jout.u)).max() <= 1e-4
  assert np.abs(np.asarray(jout.u) - s.u.numpy()).max() > 1e-2      # the step moves u


def test_twin_matches_k2_path():
  """K1's twin (make_step_batch_fused on CPU tensors) against the K2 path
  (Scene.step_batch), float32, 3 steps from the same start, within 1e-4."""
  from raisimlib_torch.ops import gpu_step

  scene = _port_scene(torch.float32)
  fused = gpu_step.make_step_batch_fused(scene)
  s1, pd = _states(load_golden("atlas_settle.npz"), B, 4, torch.float32)
  s2, tau = s1, torch.zeros_like(pd)
  with torch.inference_mode():
    for _ in range(3):
      s1 = fused(s1, tau, pd)
      s2 = scene.step_batch(s2, tau, pd)
  assert (s1.q - s2.q).abs().max() <= 1e-4
  assert (s1.u - s2.u).abs().max() <= 1e-4


def test_host_body_lanes_bitwise(tmp_path, golden):
  """Atlas's generated body as host C++ (-O0): one lane and the source's 8
  give bitwise-equal q', u', and both hold the twin's tiers."""
  from raisimlib_torch.ops import gpu_step

  sd = gpu_step.make_step_batch_fused(_port_scene(torch.float32)).sd
  s, pd = _states(golden, 4, 5, torch.float32)
  ins = [np.ascontiguousarray(x.numpy(), np.float32)
         for x in (s.q, s.u, torch.zeros_like(pd), pd)]
  outs = []
  for lanes in (1, None):
    host = host_step(sd, tmp_path, lanes=lanes, opt="-O0")
    qo, uo = np.zeros_like(ins[0]), np.zeros_like(ins[1])
    host(*(x.ctypes.data for x in ins), None, 0, qo.ctypes.data, uo.ctypes.data, 4)
    outs.append((qo, uo))
    assert np.isfinite(qo).all() and np.isfinite(uo).all()
  np.testing.assert_array_equal(outs[0][0], outs[1][0])
  np.testing.assert_array_equal(outs[0][1], outs[1][1])
  host_matches_twin(sd, host, *ins[:2], ins[3])
