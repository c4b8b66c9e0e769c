"""chip_smoke.py's K2 scenes (phases 38, 39 and 41) on the CPU against the
JAX package, at B = 2: the box tower, the box pile cut to 4 boxes (two
stacks of two; the 8-box pile's device-memory layout is a matter for the
card, tests/test_torch_cuda.py) and the constraint scene (a wire, a pin, a
compliant wire). The mixed drop is tests/test_torch_k2_mixed.py.

Each scene is built by the same World calls in both packages, its bodies
falling at 0.7 m/s so that contacts close within the 10 steps (the
constraint scene keeps its own 1 cm/s). JAX's step_batch(use_kernel=False)
is jitted once a scene; the port against it:

  * the float64 pure path (step_batch(use_kernel=False), the same
    algorithm) over the 10 steps: within 1e-8 on q and u;
  * one float32 step from each JAX state: within 1e-6 on q and 2e-4 on u
    (measured: at most 5e-8 and 2e-5 on these scenes);
  * one float64 step of the twin (step_batch's kernel path on the CPU, the
    kernel's grid-and-refine cone solve, not the reference's Newton):
    within 1e-6 on q and 1e-3 on u (measured: at most 2e-7 and 1e-4).
"""

import pytest
import torch

from torch_port_util import k2_scene_errors, k2_scene_runs

PURE, ONE32, TWIN = (1e-8, 1e-8), (1e-6, 2e-4), (1e-6, 1e-3)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
  """One intra-op thread for this module: its tensors are a few worlds
  wide, and the test workers share the machine's cores."""
  n = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(n)


@pytest.mark.parametrize("name, cut", [("tower", None), ("pile", 4), ("trio", None)])
def test_k2_scene_matches_jax(name, cut):
  js, t64, t32, traj = k2_scene_runs(name, cut)
  assert t64.pairs == js.pairs
  pure, one32, twin, compared = k2_scene_errors(t64, t32, traj)
  assert compared >= len(traj) - 1, "too few states away from contact activation"
  assert pure[0] <= PURE[0] and pure[1] <= PURE[1], pure
  assert one32[0] <= ONE32[0] and one32[1] <= ONE32[1], one32
  assert twin[0] <= TWIN[0] and twin[1] <= TWIN[1], twin
