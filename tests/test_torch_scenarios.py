"""The port's scenarios (raisimlib_torch/scenarios) against the JAX package's:

  * each JSON copy equals yaml.safe_load of its YAML;
  * load's rejections, with the JAX loader's messages, and a YAML path read
    through PyYAML (an ImportError naming the JSON copy without it);
  * build_scene of the balance, trot, stack and Atlas scenarios against JAX's
    build_scene: the model arrays, the geoms, the pairs, the solver rows, the
    gains (per group for Atlas), the standing pose and the heightmap field;
  * one f64 step of the stack, in contact, against JAX's Scene.step.

The scenes are built in float64 on the CPU."""

import glob
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from torch_port_util import GOLDEN_DIR, MODEL_FIELDS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = sorted(glob.glob(os.path.join(REPO, "raisimlib_tpu", "scenarios", "*.yaml")))
NAMES = [os.path.basename(p)[:-5] for p in YAMLS]
BUILT = ["anymal_balance", "anymal_trot_heightmap", "sphere_box_stack", "atlas_batch"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
  """One intra-op thread for this module: its tensors are a world or two
  wide, and the test workers share the machine's cores."""
  n = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(n)


def test_every_scenario_has_a_copy():
  from raisimlib_torch.scenarios.loader import _SCENARIO_DIR

  assert len(NAMES) == 5
  assert sorted(f[:-5] for f in os.listdir(_SCENARIO_DIR) if f.endswith(".json")) == NAMES


@pytest.mark.parametrize("name", NAMES)
def test_json_copy_equals_the_yaml(name):
  from raisimlib_torch import scenarios

  with open(os.path.join(REPO, "raisimlib_tpu", "scenarios", name + ".yaml")) as f:
    ref = yaml.safe_load(f)
  cfg = scenarios.load(name)
  assert cfg == ref
  assert cfg["name"] == name and "description" in cfg


BAD = {
    "bad_type": ({"name": "bad", "world": {"dt": 0.01, "objects": [{"type": "torus"}]}},
                 "unknown object type"),
    "missing_dt": ({"name": "bad2", "world": {"objects": []}}, "dt"),
    "heightmap_key": ({"name": "bad3", "world": {"dt": 0.01, "objects": [
        {"type": "heightmap", "size": [4.0, 4.0], "z_scale": 0.1}]}}, "unknown heightmap key"),
    "no_name": ({"world": {"dt": 0.01}}, "'name' key"),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_load_rejects(tmp_path, case):
  import json

  from raisimlib_torch import scenarios

  cfg, match = BAD[case]
  p = tmp_path / f"{case}.json"
  p.write_text(json.dumps(cfg))
  with pytest.raises(ValueError, match=match):
    scenarios.load(str(p))


def test_load_reads_yaml_through_pyyaml(tmp_path, monkeypatch):
  """A .yaml path loads through PyYAML; without PyYAML it raises an
  ImportError that names the package's JSON copy, and reads nothing else."""
  from raisimlib_torch import scenarios

  src = os.path.join(REPO, "raisimlib_tpu", "scenarios", "sphere_box_stack.yaml")
  assert scenarios.load(src) == scenarios.load("sphere_box_stack")
  monkeypatch.setitem(sys.modules, "yaml", None)
  with pytest.raises(ImportError, match=r"scenarios/sphere_box_stack\.json"):
    scenarios.load(src)


def _jax_build(name):
  from raisimlib_tpu import scenarios as js

  return js.build_scene(js.load(name), dtype=jnp.float64)


def _port_build(name):
  from raisimlib_torch import scenarios as ts

  return ts.build_scene(ts.load(name), dtype=torch.float64, device="cpu")


@pytest.mark.parametrize("name", BUILT)
def test_build_scene_matches_jax(name):
  from raisimlib_torch.ops import pipeline as tp
  from raisimlib_tpu.ops import pipeline as jp

  (js, jinfo), (ts, tinfo) = _jax_build(name), _port_build(name)
  m, mt = js.model, ts.model
  assert (mt.parent, mt.joint_types, mt.q_adr, mt.v_adr, mt.body_names) == (
      m.parent, m.joint_types, m.q_adr, m.v_adr, m.body_names)
  for f in MODEL_FIELDS:
    np.testing.assert_array_equal(getattr(mt, f).numpy(), np.asarray(getattr(m, f)), err_msg=f)
  g, gt = js.geoms, ts.geoms
  assert (gt.gtype, gt.body, gt.material) == (g.gtype, g.body, g.material)
  for f in ("params", "offset_pos", "offset_rot"):
    np.testing.assert_array_equal(getattr(gt, f).numpy(), np.asarray(getattr(g, f)), err_msg=f)
  assert ts.pairs == js.pairs
  assert tp.scene_row_kinds(ts) == jp.scene_row_kinds(js)
  np.testing.assert_array_equal(ts.materials.numpy(), np.asarray(js.materials))
  np.testing.assert_array_equal(ts.gravity.numpy(), np.asarray(js.gravity))
  assert ts.dt == js.dt and ts.objects == js.objects
  np.testing.assert_array_equal(ts.kp.numpy(), np.asarray(js.kp))
  np.testing.assert_array_equal(ts.kd.numpy(), np.asarray(js.kd))
  assert tinfo["standing_q"].keys() == jinfo["standing_q"].keys()
  for k, q in jinfo["standing_q"].items():
    np.testing.assert_array_equal(tinfo["standing_q"][k], np.asarray(q))
  assert tinfo.get("jmap") == jinfo.get("jmap")
  assert (ts.field is None) == (js.field is None) == (name != "anymal_trot_heightmap")
  if ts.field is not None:
    np.testing.assert_array_equal(ts.field.heights.numpy(), np.asarray(js.field.heights))
    np.testing.assert_array_equal(ts.field.center.numpy(), np.asarray(js.field.center))
    assert (ts.field.size_x, ts.field.size_y) == (js.field.size_x, js.field.size_y)
    assert tinfo["terrain"] == jinfo["terrain"]


def test_atlas_gains_are_per_group():
  """Atlas's per-group gains: stiff legs, medium back, soft arms, none on
  the floating base, by joint name, as (nv,) tensors on the world's device
  (the golden's gains)."""
  _, info = _port_build("atlas_batch")
  kp, kd = info["pd_gains"]
  assert kp.shape == kd.shape == (29,) and kp.dtype == torch.float64
  jmap = info["jmap"]["atlas"]
  for name, dof in jmap.items():
    want = (8000.0, 300.0) if "_leg_" in name else (
        (4000.0, 150.0) if name.startswith("back_") else (400.0, 20.0))
    assert (float(kp[dof]), float(kd[dof])) == want, name
  assert not kp[:6].any() and not kd[:6].any()
  g = np.load(os.path.join(GOLDEN_DIR, "atlas_settle.npz"))
  np.testing.assert_array_equal(kp.numpy(), g["kp"])
  np.testing.assert_array_equal(kd.numpy(), g["kd"])


def test_stack_step_matches_jax():
  """One f64 step of the scenario's stack from the stack golden's state 10
  steps in (the kicked box sliding on the ground, the sphere on the box):
  the port's Scene.step against JAX's, at 1e-9."""
  from raisimlib_torch.ops.integrator import State
  from raisimlib_tpu.ops.integrator import State as JState

  (js, _), (ts, _) = _jax_build("sphere_box_stack"), _port_build("sphere_box_stack")
  g = np.load(os.path.join(GOLDEN_DIR, "sphere_box_stack.npz"))
  q, u = g["q"][9], g["u"][9]
  jout = js.step(JState(q=jnp.asarray(q), u=jnp.asarray(u), t=jnp.asarray(0.0)))
  tout = ts.step(State(q=torch.tensor(q), u=torch.tensor(u), t=torch.tensor(0.0)))
  # the contacts act: the box neither falls freely nor keeps its speed
  assert abs(float(jout.u[5]) - (u[5] - 9.81 * js.dt)) > 1e-3
  assert abs(float(jout.u[3]) - u[3]) > 1e-4
  np.testing.assert_allclose(tout.q.numpy(), np.asarray(jout.q), rtol=0, atol=1e-9)
  np.testing.assert_allclose(tout.u.numpy(), np.asarray(jout.u), rtol=0, atol=1e-9)
