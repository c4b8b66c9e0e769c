"""The frozen reference (portbench/reference/) against the system's own CPU
paths at a few worlds and steps: the fused step's plain twin and the K2
path's twin in float64, the float32 twin inside the cells' limits, one MPPI
update from the same noise, and the benchmark's terrain generator."""

import os

import pytest
import torch

from portbench import inputs
from portbench.reference import mpc as rmpc
from portbench.reference.collide import Field
from portbench.reference.step import Scene as RefScene
from portbench.run import PKG, ROOT, cell_files, load_json

CONFIGS = ["anymal_flat", "anymal_terrain"]


def _cfg(name):
  return load_json(os.path.join(PKG, "configs", f"{name}.json"))


def _inputs(cfg, B, dtype, seed=3):
  g = torch.Generator().manual_seed(seed)
  q, u = inputs.standing_states(B, 0.02, g, dtype, "cpu")
  u = u + 0.3 * torch.randn(u.shape, generator=g, dtype=dtype)
  pd = inputs.pd_targets(1, B, 0.1, g, dtype, "cpu")[0]
  hts = None
  if cfg["terrain"]:
    ground = cfg["world"]["objects"][1]
    hts = inputs.terrains(B, cfg["terrain"], ground["size"], ground["samples"], g, dtype, "cpu")
    q[:, 2] += inputs.ground_height(hts, ground["size"], q[:, :2])
  return q, u, pd, hts


@pytest.mark.parametrize("name", CONFIGS)
def test_step_matches_the_system_in_float64(name):
  """Three steps of 4 worlds: the reference against the fused step's twin
  (K1's arithmetic) and the K2 path (pipeline.step_batch), float64."""
  from raisimlib_torch import scenarios
  from raisimlib_torch.ops import gpu_step, pipeline
  from raisimlib_torch.ops.integrator import State

  cfg = _cfg(name)
  d = torch.float64
  scene, _ = scenarios.build_scene({"world": cfg["world"]}, dtype=d, device="cpu")
  ref = RefScene(cfg["world"], d)
  q, u, pd, hts = _inputs(cfg, 4, d)
  fused = gpu_step.make_step_batch_fused(scene)
  zero = torch.zeros_like(u)
  s1 = s2 = State(q=q, u=u, t=torch.zeros(4, dtype=d))
  qr, ur = q, u
  with torch.inference_mode():
    for _ in range(3):
      s1 = fused(s1, zero, pd, field_heights=hts)
      s2 = pipeline.step_batch(scene, s2, zero, pd, field_heights=hts)
      qr, ur = ref.step(qr, ur, pd, hts)
  for s in (s1, s2):
    torch.testing.assert_close(s.q, qr, rtol=0, atol=1e-10)
    torch.testing.assert_close(s.u, ur, rtol=0, atol=1e-10)


@pytest.mark.parametrize("name", CONFIGS)
def test_float32_twin_reads_inside_the_limits(name):
  """The float32 twin's one-step gaps to the float64 reference, at 64
  worlds, sit far inside every cell's limits: the card's K1 reads alike."""
  from raisimlib_torch import scenarios
  from raisimlib_torch.ops import gpu_step
  from raisimlib_torch.ops.integrator import State

  cfg = _cfg(name)
  f = torch.float32
  scene, _ = scenarios.build_scene({"world": cfg["world"]}, dtype=f, device="cpu")
  q, u, pd, hts = _inputs(cfg, 64, f)
  with torch.inference_mode():
    s = gpu_step.make_step_batch_fused(scene)(State(q=q, u=u, t=torch.zeros(64, dtype=f)),
                                              torch.zeros_like(u), pd, field_heights=hts)
  d = torch.float64
  qr, ur = RefScene(cfg["world"], d).step(q.to(d), u.to(d), pd.to(d),
                                          None if hts is None else hts.to(d))
  bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
  for w in bench["workloads"]:
    if w["config"] == name:
      lim = cell_files(bench, w["name"])[1]["limits"]
      assert float((s.q.to(d) - qr).abs().max()) < 0.1 * lim["q_gap_p99"]
      assert float((s.u.to(d) - ur).abs().max()) < 0.1 * lim["u_gap_p99"]


@pytest.mark.parametrize("cell", ["anymal_flat-balance_mpc", "anymal_terrain-trot_mpc"])
def test_mppi_update_matches_the_system(cell):
  """One MPPI update from the same white noise, float64: the system's
  mppi_step_batch over its fused step's twin with the example's costs,
  against the reference's dynamics, costs and weighted average."""
  from raisimlib_torch import scenarios
  from raisimlib_torch.mpc.mppi import MPPIConfig, mppi_step_batch
  from raisimlib_torch.mpc.state_map import make_contact_dyn_batch

  bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
  _, wl, cfg = cell_files(bench, cell)
  p = dict(wl["params"], **wl["rehearsal"])
  d = torch.float64
  E, K, H, sub, cdt = p["envs"], p["samples"], p["horizon"], p["substeps"], p["control_dt"]
  scene, _ = scenarios.build_scene({"world": cfg["world"]}, dtype=d, device="cpu")
  dyn, nx, nu = make_contact_dyn_batch(scene, cdt, sub, use_pd=True, fused="require")
  g = torch.Generator().manual_seed(7)
  q0 = inputs.stance(d, "cpu")
  x0 = torch.cat([q0[None].repeat(E, 1), torch.zeros((E, nx - 19), dtype=d)], 1)
  x0[:, 19 + 4] = 0.5
  U = q0[7:].expand(E, H, nu).clone()
  eps = 0.1 * torch.randn((E, K, H, nu), generator=g, dtype=d)
  mcfg = MPPIConfig(n_samples=K, sigma=0.1, temperature=p["temperature"], smooth=p["smooth"])
  ref = RefScene(cfg["world"], d)
  if p["task"] == "trot":
    from raisimlib_torch.examples.anymal_trot_heightmap import trot_costs

    ground = cfg["world"]["objects"][1]
    hts = inputs.terrains(E, cfg["terrain"], ground["size"], ground["samples"], g, d, "cpu")
    x0[:, 2] += inputs.ground_height(hts, ground["size"], x0[:, :2])
    rc, fc = trot_costs(scene.field, float(q0[2]), p["v_target"], cdt)
    rrc, rfc = rmpc.trot_costs(p["v_target"], cdt,
                               lambda h: Field(h, torch.zeros(2, dtype=d), ground["size"]))
    ctx = (hts.repeat_interleave(K, 0),)
  else:
    from raisimlib_torch.examples.anymal_balance import balance_costs

    hts = None
    rc, fc = balance_costs(p["cost"], float(q0[2]), q0[7:], cdt)
    rrc, rfc = rmpc.balance_costs(p["cost"], cdt)
    ctx = ()
  with torch.inference_mode():
    sol = mppi_step_batch(dyn, rc, fc, x0, U, config=mcfg, eps_white=eps, env_ctx=hts)
  Us = rmpc.samples(U, eps, p["smooth"]).reshape(E * K, H, nu)
  X = x0[:, None].expand(E, K, nx).reshape(E * K, nx)
  cost = torch.zeros(E * K, dtype=d)
  for t in range(H):
    cost = cost + rrc(X, Us[:, t], *ctx)
    q, v = X[:, :19], X[:, 19:]
    pd = torch.zeros_like(v)
    pd[:, 6:] = Us[:, t]
    for _ in range(sub):
      q, v = ref.step(q, v, pd, *ctx)
    X = torch.cat([q, v], 1)
  cost = (cost + rfc(X, *ctx)).reshape(E, K)
  U_ref = rmpc.update(U, eps, cost, p["smooth"], p["temperature"])
  torch.testing.assert_close(sol.U, U_ref, rtol=0, atol=1e-9)
  torch.testing.assert_close(sol.cost, cost[:, 0], rtol=1e-9, atol=1e-12)


def test_terrain_generator_matches_the_system():
  """The benchmark's copy of the fractal terrain gives the system's
  utils/terrain.generate field from the same generator state."""
  from raisimlib_torch.utils import terrain

  t = _cfg("anymal_terrain")["terrain"]
  props = terrain.TerrainProperties(x_size=12.0, y_size=6.0, x_samples=48, y_samples=24,
                                    frequency=t["frequency"], z_scale=t["z_scale"],
                                    fractal_octaves=t["octaves"],
                                    fractal_lacunarity=t["lacunarity"],
                                    fractal_gain=t["gain"])
  mine = inputs.terrains(1, t, (12.0, 6.0), (48, 24), torch.Generator().manual_seed(5),
                         torch.float32, "cpu")[0]
  theirs = terrain.generate(props, torch.Generator().manual_seed(5), device="cpu").heights
  torch.testing.assert_close(mine, theirs, rtol=0, atol=1e-7)


def test_test_file_names_are_new():
  """No test file here shares its name with one of the repository's tests/."""
  here = [f for f in os.listdir(os.path.dirname(__file__)) if f.startswith("test_")]
  assert here and not set(here) & set(os.listdir(os.path.join(ROOT, "tests")))
