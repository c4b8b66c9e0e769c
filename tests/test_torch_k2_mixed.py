"""chip_smoke.py's mixed drop (phase 40) on the CPU against the JAX package,
at B = 2, cut to the static box, the ground, the two crossed capsules and
the dumbbell compound (capsule-capsule, the box-capsule support pairs, a
compound's geoms on one body). JAX's compile of the whole scene (51 pairs)
takes about a minute, of this cut 11 s; the other pairs' narrow phases are
held to JAX's one by one in tests/test_torch_convex_pairs.py.

As tests/test_torch_k2_scenes.py: the bodies falling at 0.7 m/s, 10 steps;
the float64 pure path within 1e-8, one float32 step from each JAX state
within 1e-6 on q and 2e-4 on u, one float64 step of the twin within 1e-6
and 1e-3."""

import pytest
import torch

from torch_port_util import k2_scene_errors, k2_scene_runs
from torch_port_util import one_thread  # noqa: F401  (a module fixture)

PURE, ONE32, TWIN = (1e-8, 1e-8), (1e-6, 2e-4), (1e-6, 1e-3)


def test_mixed_drop_matches_jax():
  js, t64, t32, traj = k2_scene_runs("mixed", ("capsules", "dumbbell"))
  assert t64.pairs == js.pairs
  pure, one32, twin, compared = k2_scene_errors(t64, t32, traj)
  assert compared >= len(traj) - 1, "too few states away from contact activation"
  assert pure[0] <= PURE[0] and pure[1] <= PURE[1], pure
  assert one32[0] <= ONE32[0] and one32[1] <= ONE32[1], one32
  assert twin[0] <= TWIN[0] and twin[1] <= TWIN[1], twin
