"""Which builds call the cone solve out of line: string checks of the
sources and the rule, no compiler (the card test
test_torch_cuda.py::test_fused_step_called_and_inlined_solve_agree_bitwise
holds the two forms' bits equal).

csrc/cone_solve.cuh lets its includer choose the attribute of
`rsl::cone_solve_lanes` (RSL_CONE_SOLVE_ATTR, by default __forceinline__).
The fused step (K1) calls the solve from one site per contact slot in each
sweep, so its generated head defines __noinline__ before the include where
`gpu_step.solve_called` says the build gains by it (enough slots, and at 32
lanes a small enough nv); the matrix-free solve (K2) calls it from one site
in its row loop and keeps the inlined default."""

import os
import re

import pytest

from raisimlib_torch import _build
from raisimlib_torch.ops import gpu_step as gs
from torch_port_util import load_chip_smoke
from torch_port_util import one_thread  # noqa: F401  (a module fixture)

CALL = "#define RSL_CONE_SOLVE_ATTR __noinline__"
INCLUDE = '#include "cone_solve.cuh"'


def _read(name):
  with open(os.path.join(_build.CSRC, name)) as f:
    return f.read()


@pytest.fixture(scope="module")
def kernels():
  """{scene: its FusedKernel} for the benchmark's three scenarios: ANYmal on
  the plane (K1a), on a heightmap (K1c) and Atlas (K1a at nv = 29)."""
  import torch

  from raisimlib_torch import scenarios

  return {name: gs.make_step_batch_fused(scenarios.build_scene(
      scenarios.load(name), dtype=torch.float32, device="cpu")[0]).kernel
      for name in ("anymal_balance", "anymal_trot_heightmap", "atlas_batch")}


@pytest.mark.parametrize("name, slots, called", [
    ("anymal_balance", 12, {gs.LANES: True, gs.WIDE: True}),
    ("anymal_trot_heightmap", 12, {gs.LANES: True, gs.WIDE: True}),
    ("atlas_batch", 32, {gs.LANES: True, gs.WIDE: False})])
def test_fused_step_defines_the_call_before_the_include(kernels, name, slots, called):
  """The source each build compiles defines the out-of-line attribute once,
  ahead of the include, where the rule calls the solve (ANYmal at 8 and 32
  lanes, Atlas at 8), and not at all where it inlines it (Atlas at 32); the
  sweep calls the solve from one site per contact slot either way."""
  kern = kernels[name]
  assert len(kern.sd.slots) == slots
  assert kern.called == called
  for lanes, src in kern.sources.items():
    assert src.count(CALL + "\n") == int(called[lanes]), lanes
    assert len(re.findall(r"\bRSL_CONE_SOLVE_ATTR\b", src)) == int(called[lanes]), lanes
    if called[lanes]:
      assert src.index(CALL) < src.index(INCLUDE), lanes
    assert src.count("rsl::cone_solve_lanes(") == slots, lanes


@pytest.mark.parametrize("scene, slots, nv, called", [
    ("stack", 10, 12, {gs.LANES: True, gs.WIDE: False}),
    ("cylinder", 6, 6, {gs.LANES: False, gs.WIDE: False}),
    ("cone", 4, 6, {gs.LANES: False, gs.WIDE: False}),
    ("mesh", 4, 6, {gs.LANES: False, gs.WIDE: False})])
def test_solve_call_rule_on_the_loose_body_scenes(scene, slots, nv, called):
  """chip_smoke.py's sphere-box stack (K1b) calls the solve at 8 lanes only;
  the debris scenes (a cylinder, a cone, a rock on a heightmap), with 4-6
  slots, inline it at both widths."""
  import torch

  cs = load_chip_smoke()
  sc = (cs.stack_scene(torch, device="cpu") if scene == "stack"
        else cs.debris_scene(torch, scene, device="cpu"))
  sd = gs.make_step_batch_fused(sc, use_pd=False).sd
  assert (len(sd.slots), sd.nv) == (slots, nv)
  assert {n: gs.solve_called(sd, n) for n in (gs.LANES, gs.WIDE)} == called


def test_solve_call_thresholds():
  """The rule's thresholds at each width: slots at CALL_MIN_SLOTS[lanes]
  and one fewer, nv at CALL_WIDE_MAX_NV and one more (only the wide build
  reads nv); kernel_source writes the define where the rule calls."""
  import torch

  from raisimlib_torch import scenarios

  sd = gs.make_step_batch_fused(scenarios.build_scene(
      scenarios.load("anymal_balance"), dtype=torch.float32, device="cpu")[0]).sd
  for lanes in (gs.LANES, gs.WIDE):
    n = gs.CALL_MIN_SLOTS[lanes]
    assert gs.solve_called(sd._replace(slots=sd.slots[:n]), lanes)
    assert not gs.solve_called(sd._replace(slots=sd.slots[:n - 1]), lanes)
  nv = gs.CALL_WIDE_MAX_NV
  assert gs.solve_called(sd._replace(nv=nv), gs.WIDE)
  assert not gs.solve_called(sd._replace(nv=nv + 1), gs.WIDE)
  assert gs.solve_called(sd._replace(nv=nv + 1), gs.LANES)
  few = sd._replace(slots=sd.slots[:gs.CALL_MIN_SLOTS[gs.LANES] - 1])
  assert CALL not in gs.kernel_source(few)[0] and CALL in gs.kernel_source(sd)[0]


def test_cone_solve_defaults_to_inlined():
  """cone_solve.cuh inlines the solve unless its includer says otherwise,
  and its helpers stay inlined into it either way."""
  text = _read("cone_solve.cuh")
  default = "#ifndef RSL_CONE_SOLVE_ATTR\n#define RSL_CONE_SOLVE_ATTR __forceinline__\n#endif"
  assert default in text
  assert text.index(default) < text.index("namespace rsl {")
  assert text.count("#define RSL_CONE_SOLVE_ATTR") == 1
  assert "__device__ RSL_CONE_SOLVE_ATTR void cone_solve_lanes(" in text
  for helper in ("stick_solve", "cone_curve_sc", "cone_curve", "cone_curve_E", "cone_key",
                 "lanes_argmin", "cone_grid_trig"):
    assert re.search(rf"__device__ __forceinline__ \w+ {helper}\(", text), helper


@pytest.mark.parametrize("name", ["mf_solve.cu", "mf_solve.cuh"])
def test_matrix_free_solve_keeps_the_inlined_default(name):
  """K2's sources define no attribute for the solve: it stays inlined."""
  text = _read(name)
  assert "RSL_CONE_SOLVE_ATTR" not in text
  assert "__noinline__" not in text
