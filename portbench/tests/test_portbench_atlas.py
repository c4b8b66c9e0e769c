"""The `atlas` configuration: its frozen reference (portbench/reference/
atlas.py) against the system's model and CPU step paths in float64, the
float32 twin inside the cell's limits, the frozen yardstick against the
kernel's tally, and the `atlas-rollouts` cell rehearsed on the CPU: correct
for the system, not correct for the control and each planted fault."""

import os

import pytest
import torch

from portbench import control_atlas
from portbench.drivers import atlas_rollouts as driver
from portbench.reference import atlas
from portbench.rehearse import rehearse
from portbench.run import PKG, ROOT, cell_files, execute, load_json

CELL = "atlas-rollouts"


def _cfg():
  return load_json(os.path.join(PKG, "configs", "atlas.json"))


def _scene(dtype):
  from raisimlib_torch import scenarios

  return scenarios.build_scene({"world": _cfg()["world"]}, dtype=dtype, device="cpu")


def _inputs(B, dtype, seed=3):
  g = torch.Generator().manual_seed(seed)
  q0 = torch.as_tensor(atlas.standing_q(), dtype=dtype)
  q, u = driver.standing_states(q0, B, 0.01, g)
  u = u + 0.3 * torch.randn(u.shape, generator=g, dtype=dtype)
  return q, u, driver.pd_targets(q0, 1, B, 0.1, g)[0]


def _limits():
  return cell_files(load_json(os.path.join(ROOT, "BENCHMARK.json")), CELL)[1]["limits"]


def test_reference_model_is_the_systems():
  """nq 30, nv 29, 32 box-corner slots, 23 limit rows; the URDF, stance,
  masses, limits and per-group gains equal the system's."""
  from raisimlib_torch.models import atlas as system_atlas
  from raisimlib_torch.ops import gpu_step

  scene, info = _scene(torch.float64)
  ref = atlas.Scene(_cfg()["world"])
  m = ref.model
  assert (m.nq, m.nv, ref.n_slots, ref.limit_v.numel()) == (30, 29, 32, 23)
  sd = gpu_step.make_step_batch_fused(scene).sd
  assert (sd.nq, sd.nv, len(sd.slots), len(sd.limits)) == (30, 29, 32, 23)
  assert atlas.atlas_urdf() == system_atlas.atlas_urdf()
  assert atlas.joint_dofs(atlas.atlas_urdf()) == info["jmap"]["atlas"]
  torch.testing.assert_close(torch.as_tensor(atlas.standing_q()),
                             torch.as_tensor(info["standing_q"]["atlas"]), rtol=0, atol=0)
  sm = scene.model
  torch.testing.assert_close(torch.as_tensor(m.inertia[:, 3, 3]), sm.mass.cpu(), rtol=1e-12,
                             atol=0)
  torch.testing.assert_close(torch.as_tensor(m.joint_lo), sm.joint_lo.cpu().double())
  torch.testing.assert_close(torch.as_tensor(m.joint_hi), sm.joint_hi.cpu().double())
  torch.testing.assert_close(ref.kp, scene.kp, rtol=0, atol=0)
  torch.testing.assert_close(ref.D, scene.kd, rtol=0, atol=0)
  assert sorted(set(ref.kp.tolist())) == [0.0, 400.0, 4000.0, 8000.0]


def test_step_matches_the_system_in_float64():
  """Three steps of 3 worlds: the reference against the fused step's twin
  (K1's arithmetic) and the K2 path (pipeline.step_batch), float64."""
  from raisimlib_torch.ops import gpu_step, pipeline
  from raisimlib_torch.ops.integrator import State

  d = torch.float64
  scene, _ = _scene(d)
  ref = atlas.Scene(_cfg()["world"], d)
  q, u, pd = _inputs(3, d)
  fused = gpu_step.make_step_batch_fused(scene)
  zero = torch.zeros_like(u)
  s1 = s2 = State(q=q, u=u, t=torch.zeros(3, dtype=d))
  qr, ur = q, u
  with torch.inference_mode():
    for _ in range(3):
      s1 = fused(s1, zero, pd)
      s2 = pipeline.step_batch(scene, s2, zero, pd)
      qr, ur = ref.step(qr, ur, pd)
  for s in (s1, s2):
    torch.testing.assert_close(s.q, qr, rtol=0, atol=1e-10)
    torch.testing.assert_close(s.u, ur, rtol=0, atol=1e-10)


def test_float32_twin_reads_inside_the_limits():
  """The float32 twin's one-step gaps to the float64 reference, at 64
  worlds, sit far inside the cell's limits: the card's K1 reads alike."""
  from raisimlib_torch.ops import gpu_step
  from raisimlib_torch.ops.integrator import State

  f, d = torch.float32, torch.float64
  scene, _ = _scene(f)
  q, u, pd = _inputs(64, f)
  with torch.inference_mode():
    s = gpu_step.make_step_batch_fused(scene)(State(q=q, u=u, t=torch.zeros(64, dtype=f)),
                                              torch.zeros_like(u), pd)
  qr, ur = atlas.Scene(_cfg()["world"], d).step(q.to(d), u.to(d), pd.to(d))
  lim = _limits()
  assert float((s.q.to(d) - qr).abs().max()) < 0.1 * lim["q_gap_p99"]
  assert float((s.u.to(d) - ur).abs().max()) < 0.1 * lim["u_gap_p99"]


def test_yardstick_is_the_kernels_tally():
  """The configuration's frozen operations and height loads per world are
  what the emitter counts for the scene today."""
  from raisimlib_torch.ops import gpu_step

  y = _cfg()["yardstick"]
  sd = gpu_step.make_step_batch_fused(_scene(torch.float32)[0]).sd
  _, ops, loads = gpu_step.kernel_source(sd)
  assert (ops, loads) == (y["ops_per_world"], y["height_loads_per_world"])
  assert (y["nq"], y["nv"], y["use_pd"]) == (sd.nq, sd.nv, sd.use_pd)


def test_the_system_is_correct():
  out = rehearse(CELL, seed=2147483711, seconds=0.1)
  assert out["correct"], out["checks"]
  assert out["attempted"] > 0 and out["failed"] == 0


def _substituted(sub, seed, every=False):
  bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
  _, wl, cfg = cell_files(bench, CELL)
  p = dict(wl["params"], **wl["rehearsal"])
  extra = {"check_worlds": p["worlds"]} if every else {}
  return execute(bench, CELL, seed, 0.1, trace=False, device="cpu",
                 overrides=dict(wl["rehearsal"], **extra),
                 substitute=sub(cfg, dict(p, **extra), wl["driver"]))


@pytest.mark.parametrize("kind", ["unchanged", "altered", "rare"])
def test_a_fault_is_not_correct(kind):
  """A step that returns its state, an answer altered in every world, or
  altered in one world of 64 alone (every world of the rehearsal checked:
  `u_gap_max` fails it)."""
  out = _substituted(lambda cfg, p, drv: control_atlas.faults(p, drv, kind), 12,
                     every=kind == "rare")
  assert not out["correct"], out["checks"]
  if kind == "rare":
    assert out["checks"]["u_gap_max"]["value"] > out["checks"]["u_gap_max"]["limit"]


def test_the_control_is_not_correct():
  out = _substituted(control_atlas.control, 13)
  assert not out["correct"], out["checks"]


@pytest.mark.cuda
def test_the_control_on_the_card_is_not_correct():
  """The control at the cell's 1024 worlds on the card; skips without a
  CUDA device (`python3 -m portbench.control_atlas` runs it in full)."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device: the control is measured on the card")
  bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
  _, wl, cfg = cell_files(bench, CELL)
  sizes = {"check_first": 1}
  out = execute(bench, CELL, 2147483747, 0.5, trace=False, overrides=sizes,
                substitute=control_atlas.control(cfg, dict(wl["params"], **sizes), wl["driver"]))
  assert not out["correct"], out["checks"]
