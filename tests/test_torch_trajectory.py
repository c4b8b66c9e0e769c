"""Trajectories and metrics of the port (raisimlib_torch/utils/trajectory.py,
utils/metrics.py, ops/pipeline.step_with_report) against the JAX package's:

  * record on the falling ball: the file schema, the ball at rest on the
    ground, impulses only after touchdown and pushing up (as
    tests/test_trajectory.py);
  * step_with_report against JAX's on one f64 step of the stack in contact:
    the state, the contact set, the impulses in the contact and world frames;
  * from_states' body poses against JAX's for the same ANYmal coordinates;
  * save and load round-trip; the replay example renders a PNG;
  * metrics.emit takes tensors."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import GOLDEN_DIR


@pytest.fixture(scope="module", autouse=True)
def one_thread():
  """One intra-op thread for this module: its tensors are a world wide, and
  the test workers share the machine's cores."""
  n = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(n)


def _drop_scene():
  from raisimlib_torch.world import World

  world = World(dt=0.002, dtype=torch.float64, device="cpu")
  world.add_sphere(radius=0.1, mass=1.0, pos=(0.0, 0.0, 0.5))
  world.add_ground()
  return world.compile()


@pytest.fixture(scope="module")
def drop_traj():
  from raisimlib_torch.utils import trajectory

  scene = _drop_scene()
  return scene, trajectory.record(scene, scene.init_state(), n_steps=200)


def test_record_schema_and_physics(drop_traj):
  scene, traj = drop_traj
  nq, nv, nb = scene.model.nq, scene.model.nv, scene.model.nb
  assert traj["q"].shape == (201, nq) and traj["u"].shape == (201, nv)
  assert traj["t"].shape == (201,) and traj["t"][-1] == pytest.approx(0.4)
  assert traj["body_pos"].shape == (201, nb, 3) and traj["body_rot"].shape == (201, nb, 3, 3)
  nc = traj["con_pos"].shape[1]
  assert traj["con_pos"].shape == traj["con_nrm"].shape == traj["con_imp"].shape == (200, nc, 3)
  assert traj["con_act"].shape == (200, nc)
  assert float(traj["dt"]) == 0.002 and list(traj["body_names"]) == list(scene.model.body_names)
  # the ball falls from 0.5 m and settles on the ground at z ~= r
  z = traj["body_pos"][:, 0, 2]
  assert z[0] > 0.45 and abs(z[-1] - 0.1) < 0.02
  # impulses appear only after touchdown, and push up
  imp_n = (traj["con_imp"] * traj["con_nrm"]).sum(-1) * traj["con_act"]
  touchdown = np.nonzero(imp_n.sum(1) > 1e-6)[0]
  assert len(touchdown) > 0 and touchdown[0] > 10
  assert imp_n.min() > -1e-9


def test_save_load_round_trip_and_replay(drop_traj, tmp_path):
  from raisimlib_torch.utils import trajectory

  _, traj = drop_traj
  p = str(tmp_path / "sub" / "drop.npz")
  trajectory.save(p, traj)
  back = trajectory.load(p)
  assert set(back) == set(traj)
  for k in traj:
    np.testing.assert_array_equal(back[k], traj[k], err_msg=k)
  pytest.importorskip("matplotlib")
  from raisimlib_torch.examples import replay

  out = replay.main([p, "-o", str(tmp_path / "drop.png")])
  assert os.path.getsize(out) > 10_000


def _stack_state(step):
  g = np.load(os.path.join(GOLDEN_DIR, "sphere_box_stack.npz"))
  return g["q"][step], g["u"][step]


def test_step_with_report_matches_jax():
  """One f64 step of the scenario's stack 10 steps in (the kicked box
  sliding on its 4 bottom corners, the sphere still falling onto it): the
  state, the contact set and the impulses in both frames, against JAX's
  step_with_report at 1e-9."""
  from raisimlib_torch import scenarios
  from raisimlib_torch.ops import pipeline
  from raisimlib_torch.ops.integrator import State
  from raisimlib_tpu import scenarios as jscenarios
  from raisimlib_tpu.ops import pipeline as jpipeline
  from raisimlib_tpu.ops.integrator import State as JState

  ts = scenarios.build_scene(scenarios.load("sphere_box_stack"), dtype=torch.float64,
                             device="cpu")[0]
  js = jscenarios.build_scene(jscenarios.load("sphere_box_stack"), dtype=jnp.float64)[0]
  q, u = _stack_state(9)
  js2, jc, jl, jw = jpipeline.step_with_report(
      js, JState(q=jnp.asarray(q), u=jnp.asarray(u), t=jnp.asarray(0.0)), jnp.zeros(12))
  with torch.inference_mode():
    ts2, tc, tl, tw = pipeline.step_with_report(
        ts, State(q=torch.tensor(q)[None], u=torch.tensor(u)[None], t=torch.zeros(1)),
        torch.zeros((1, 12), dtype=torch.float64))
  assert float(np.asarray(jc.active).sum()) == 4                   # the box's bottom corners

  def close(a, b, what):
    np.testing.assert_allclose(a[0].numpy(), np.asarray(b), rtol=0, atol=1e-9, err_msg=what)

  close(ts2.q, js2.q, "q")
  close(ts2.u, js2.u, "u")
  for f in ("pos", "normal", "depth", "active"):
    close(getattr(tc, f), getattr(jc, f), f)
  close(tl, jl, "lam_loc")
  close(tw, jw, "lam_world")
  # world-frame impulses: the normal part along the normal
  nc = tc.pos.shape[1]
  np.testing.assert_allclose((tw[0, :nc] * tc.normal[0]).sum(-1).numpy(), tl[0, :nc, 2].numpy(),
                             atol=1e-12)


def test_from_states_matches_jax():
  """from_states' body poses (batched FK) for 5 ANYmal coordinates against
  JAX's, and its time axis."""
  from raisimlib_torch import scenarios
  from raisimlib_torch.utils import trajectory
  from raisimlib_tpu import scenarios as jscenarios
  from raisimlib_tpu.utils import trajectory as jtrajectory

  ts, info = scenarios.build_scene(scenarios.load("anymal_balance"), dtype=torch.float64,
                                   device="cpu")
  js = jscenarios.build_scene(jscenarios.load("anymal_balance"), dtype=jnp.float64)[0]
  rng = np.random.RandomState(0)
  qs = np.tile(info["standing_q"]["anymal"], (5, 1)) + 0.1 * rng.randn(5, 19)
  qs[:, 3:7] /= np.linalg.norm(qs[:, 3:7], axis=1, keepdims=True)
  us = rng.randn(5, 18)
  ours = trajectory.from_states(ts, torch.tensor(qs), torch.tensor(us), dt=0.01)
  ref = jtrajectory.from_states(js, qs, us, dt=0.01)
  assert set(ours) == set(ref)
  for k in ("body_pos", "body_rot"):
    np.testing.assert_allclose(ours[k], ref[k], rtol=0, atol=1e-12, err_msg=k)
  for k in ("q", "u", "t", "dt", "body_names"):
    np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)


def test_metrics_emit_takes_tensors(tmp_path, capsys):
  from raisimlib_torch.utils import metrics

  p = str(tmp_path / "m" / "x.jsonl")
  rec = metrics.emit("probe", path=p, echo=True, a=torch.tensor(1.5), b=torch.arange(3),
                     c=np.float32(2.0), d=[1, 2], e="s")
  assert rec["a"] == 1.5 and rec["b"] == [0, 1, 2] and rec["c"] == 2.0
  line = capsys.readouterr().out.strip()
  assert json.loads(line) == rec
  log = metrics.MetricsLogger(p, run="r1")
  log.emit("probe2", x=torch.tensor([[1.0, 2.0]]))
  recs = log.read_all()
  assert [r["kind"] for r in recs] == ["probe", "probe2"]
  assert recs[1]["x"] == [[1.0, 2.0]] and recs[1]["run"] == "r1"
