"""The port's examples (raisimlib_torch/examples) against the JAX package's
examples/:

  * the batched balance and trot costs and gait_reference against JAX's
    per-sample functions under vmap, on the same states and actions;
  * each example's run(smoke=True, device="cpu") in this process, its
    scenario's smoke sizes cut to a few physics steps: finite results, every
    key of the JAX example's record, the step path, and the trajectory file
    beside the metrics file where the JAX example writes one.

On the CPU the examples step through the kernels' plain twins; chip_smoke.py
runs them at full size on the card, with their gates."""

import importlib.util
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import jax_record_keys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
  """One intra-op thread for this module: its tensors are a few worlds
  wide, and the test workers share the machine's cores."""
  n = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(n)


def _jax_example(name):
  """examples/<name>.py as a module (its top level imports jax only)."""
  spec = importlib.util.spec_from_file_location(f"jax_example_{name}",
                                                os.path.join(REPO, "examples", f"{name}.py"))
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod


def _samples(n, seed, x0, nu, act0):
  """n states around x0 (q, u noisy, quaternion renormalised) and actions."""
  rng = np.random.RandomState(seed)
  X = np.tile(x0, (n, 1)) + 0.05 * rng.randn(n, x0.size)
  X[:, 3:7] /= np.linalg.norm(X[:, 3:7], axis=1, keepdims=True)
  A = np.tile(act0, (n, 1)) + 0.1 * rng.randn(n, nu)
  return X, A


def test_balance_costs_match_jax_vmap():
  """examples/anymal_balance.py's per-sample rc/fc (the same expressions),
  vmapped, against the port's batched balance_costs, f64."""
  from raisimlib_torch import scenarios
  from raisimlib_torch.examples import anymal_balance
  from raisimlib_torch.models import anymal
  from raisimlib_tpu.ops.spatial import quat_box_minus

  cfg = scenarios.load("anymal_balance")
  cw, control_dt = cfg["run"]["cost"], cfg["controller"]["control_dt"]
  q0 = anymal.standing_q()
  z0, q_stand = q0[2], jnp.asarray(q0[7:])
  quat_id = jnp.array([1.0, 0.0, 0.0, 0.0])

  def rc(x, u, t):
    q, v = x[:19], x[19:]
    return (cw["height"] * (q[2] - z0) ** 2
            + cw["orientation"] * jnp.sum(quat_box_minus(q[3:7], quat_id) ** 2)
            + cw["base_vel"] * jnp.sum(v[:6] ** 2)
            + cw["joint_vel"] * jnp.sum(v[6:] ** 2)
            + cw["posture"] * jnp.sum((q[7:] - q_stand) ** 2)
            + cw["effort"] * jnp.sum((u - q_stand) ** 2)) * control_dt

  def fc(x):
    q, v = x[:19], x[19:]
    return (200.0 * (q[2] - z0) ** 2
            + 50.0 * jnp.sum(quat_box_minus(q[3:7], quat_id) ** 2)
            + 5.0 * jnp.sum(v[:6] ** 2))

  X, A = _samples(16, 0, np.concatenate([q0, np.zeros(18)]), 12, q0[7:])
  trc, tfc = anymal_balance.balance_costs(cw, float(z0), torch.tensor(q0[7:]), control_dt)
  np.testing.assert_allclose(trc(torch.tensor(X), torch.tensor(A), 3).numpy(),
                             np.asarray(jax.vmap(rc, (0, 0, None))(X, A, 3)), rtol=1e-12)
  np.testing.assert_allclose(tfc(torch.tensor(X)).numpy(), np.asarray(jax.vmap(fc)(X)),
                             rtol=1e-12)


def test_gait_reference_matches_jax():
  from raisimlib_torch.examples import anymal_trot_heightmap

  ref = _jax_example("anymal_trot_heightmap").gait_reference(166, 0.02, freq=1.5, swing=0.22,
                                                             dtype=jnp.float64)
  ours = anymal_trot_heightmap.gait_reference(166, 0.02, freq=1.5, swing=0.22,
                                              dtype=torch.float64, device="cpu")
  assert ours.shape == (166, 12)
  np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=1e-12)


def test_trot_costs_match_jax_vmap():
  """examples/anymal_trot_heightmap.py's per-sample rc/fc on each sample's
  own terrain (the same expressions), vmapped, against the port's batched
  trot_costs, f64."""
  from raisimlib_torch import scenarios
  from raisimlib_torch.examples import anymal_trot_heightmap
  from raisimlib_torch.models import anymal
  from raisimlib_tpu import scenarios as jscenarios
  from raisimlib_tpu.ops import heightmap as hm
  from raisimlib_tpu.ops.spatial import quat_box_minus

  v_target, control_dt = 0.35, 0.02
  q0 = anymal.standing_q()
  z0 = q0[2]
  quat_id = jnp.array([1.0, 0.0, 0.0, 0.0])
  field0 = jscenarios.build_scene(jscenarios.load("anymal_trot_heightmap"),
                                  dtype=jnp.float64)[0].field

  def rc(x, u, t, heights):
    q, v = x[:19], x[19:]
    z_surf, _, _ = hm.surface_at(field0.replace(heights=heights), q[:2])
    return (9.0 * (v[3] - v_target) ** 2
            + 30.0 * (q[2] - z_surf - z0) ** 2
            + 8.0 * jnp.sum(quat_box_minus(q[3:7], quat_id) ** 2)
            + 0.3 * (v[4] ** 2 + v[5] ** 2)
            + 0.02 * jnp.sum(v[6:] ** 2)) * control_dt

  def fc(x, heights):
    q = x[:19]
    z_surf, _, _ = hm.surface_at(field0.replace(heights=heights), q[:2])
    return (100.0 * (q[2] - z_surf - z0) ** 2
            + 30.0 * jnp.sum(quat_box_minus(q[3:7], quat_id) ** 2))

  n = 8
  X, A = _samples(n, 1, np.concatenate([q0, np.zeros(18)]), 12, q0[7:])
  X[:, :2] += np.random.RandomState(2).uniform(-2.0, 2.0, (n, 2))
  hts = 0.05 * np.random.RandomState(3).randn(n, 48, 24)
  scene = scenarios.build_scene(scenarios.load("anymal_trot_heightmap"), dtype=torch.float64,
                                device="cpu")[0]
  trc, tfc = anymal_trot_heightmap.trot_costs(scene.field, float(z0), v_target, control_dt)
  tX, tA, th = torch.tensor(X), torch.tensor(A), torch.tensor(hts)
  np.testing.assert_allclose(trc(tX, tA, 0, th).numpy(),
                             np.asarray(jax.vmap(rc, (0, 0, None, 0))(X, A, 0, hts)), rtol=1e-12)
  np.testing.assert_allclose(tfc(tX, th).numpy(), np.asarray(jax.vmap(fc)(X, hts)), rtol=1e-12)


# each example's smoke sizes cut to a few physics steps (entries of its
# scenario), its JAX counterpart, and the trajectory file it writes (if any)
RUNS = {
    "sphere_box_stack": ({"run": {"smoke_seconds": 0.02}}, "sphere_box_stack", None),
    "anymal_balance": ({"controller": {"smoke_horizon": 2, "smoke_samples": 4},
                        "run": {"smoke_ticks": 1}}, "anymal_balance", "anymal_balance_traj.npz"),
    "anymal_trot_heightmap": ({"controller": {"smoke_horizon": 1, "smoke_samples": 4},
                               "run": {"smoke_ticks": 1}}, "anymal_trot_heightmap",
                              "anymal_trot_traj.npz"),
    "atlas_batch": ({"run": {"smoke_batch": 4, "smoke_horizon": 2}}, "atlas_batch", None),
}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_example_runs_on_the_cpu(name, tmp_path, monkeypatch):
  """run(smoke=True, device="cpu") with the scenario's smoke sizes cut down
  (the twins take 0.1-0.7 s a step on the CPU)."""
  from raisimlib_torch import scenarios

  cut, jax_name, traj_file = RUNS[name]
  load = scenarios.load

  def cut_load(n):
    cfg = load(n)
    for section, values in cut.items():
      cfg[section].update(values)
    return cfg

  monkeypatch.setattr(scenarios, "load", cut_load)
  mod = importlib.import_module(f"raisimlib_torch.examples.{name}")
  path = str(tmp_path / f"{name}.jsonl")
  res = mod.run(smoke=True, device="cpu", metrics_path=path)
  missing = jax_record_keys(jax_name) - set(res)
  assert not missing, missing
  assert res["step_path"] == "K1" and res["device"] == "cpu" and res["physics_steps"] > 0
  for k, v in res.items():
    if isinstance(v, float):
      assert math.isfinite(v), (k, v)
  with open(path) as f:
    lines = f.read().splitlines()
  assert len(lines) == 1 and f'"kind": "example_{name}"' in lines[0]
  if traj_file is not None:
    from raisimlib_torch.utils import trajectory

    traj = trajectory.load(str(tmp_path / traj_file))
    assert traj["q"].shape[0] == res["ticks"] == 1 and np.isfinite(traj["body_pos"]).all()


def test_atlas_scaling_is_not_ported():
  from raisimlib_torch.examples import atlas_batch

  with pytest.raises(NotImplementedError, match="ROADMAP.md item 15"):
    atlas_batch.run(scaling=True, device="cpu")
