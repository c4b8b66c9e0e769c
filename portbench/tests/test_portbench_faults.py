"""`correct` on the CPU rehearsal path (the kernels' plain twins, tiny
sizes): true for the system, false for the control (the reference with
TF32 products in the system's place) and for each fault the cells can
have: a step that returns its state unchanged, an answer altered where it
is produced, in every world or in one world of 64 alone."""

import pytest

from portbench import control
from portbench.rehearse import rehearse
from portbench.run import ROOT, cell_files, execute, load_json

CELLS = ["anymal_flat-rollouts", "anymal_terrain-trot_mpc", "anymal_flat-balance_mpc",
         "anymal_terrain-rollouts"]


def _params(cell):
  bench = load_json(f"{ROOT}/BENCHMARK.json")
  _, wl, cfg = cell_files(bench, cell)
  return cfg, dict(wl["params"], **wl["rehearsal"]), wl["driver"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_system_is_correct(cell):
  out = rehearse(cell, seed=2147483711, seconds=0.1)
  assert out["correct"], out["checks"]
  assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("kind", ["unchanged", "altered"])
def test_a_fault_is_not_correct(cell, kind):
  _, p, driver = _params(cell)
  out = rehearse(cell, seed=12, seconds=0.1, substitute=control.faults(p, driver, kind))
  assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", ["anymal_flat-rollouts", "anymal_terrain-trot_mpc"])
def test_the_control_is_not_correct(cell):
  cfg, p, driver = _params(cell)
  out = rehearse(cell, seed=13, seconds=0.1, substitute=control.control(cfg, p, driver))
  assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_fault_in_one_world_of_64_is_not_correct(cell):
  """The fault confined to world 0 of every 64: with every row of the
  rehearsal checked, `*_gap_max` fails it."""
  bench = load_json(f"{ROOT}/BENCHMARK.json")
  _, wl, _ = cell_files(bench, cell)
  _, p, driver = _params(cell)
  every = {"check_worlds": p["worlds"]} if driver == "rollouts" else \
      {"check_rows": p["envs"] * p["samples"]}
  out = execute(bench, cell, 12, 0.1, trace=False, device="cpu",
                overrides=dict(wl["rehearsal"], **every),
                substitute=control.faults(dict(p, **every), driver, "rare"))
  assert not out["correct"], out["checks"]
  assert out["checks"]["u_gap_max"]["value"] > out["checks"]["u_gap_max"]["limit"]
