"""The control on the card at a size a test run holds: the reference with
TF32 products in the system's place must come out not correct. It skips
without a CUDA device (`python3 -m portbench.control` runs it at the
cells' own sizes)."""

import pytest
import torch

from portbench import control
from portbench.run import ROOT, cell_files, execute, load_json

SIZES = {"rollouts": {"worlds": 1024, "check_first": 1},
         "mpc_loop": {"samples": 32, "horizon": 8, "check_ticks": 2}}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["anymal_flat-rollouts", "anymal_terrain-rollouts",
                                  "anymal_flat-balance_mpc", "anymal_terrain-trot_mpc"])
def test_the_control_on_the_card_is_not_correct(cell):
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device: the control is measured on the card")
  bench = load_json(f"{ROOT}/BENCHMARK.json")
  _, wl, cfg = cell_files(bench, cell)
  sizes = SIZES[wl["driver"]]
  p = dict(wl["params"], **sizes)
  out = execute(bench, cell, 2147483747, 0.5, trace=False, overrides=sizes,
                substitute=control.control(cfg, p, wl["driver"]))
  assert not out["correct"], out["checks"]
