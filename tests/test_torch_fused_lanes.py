"""The fused step's lanes (K1, ops/gpu_step.py + csrc/fused_step.cuh), on the
CPU: the generated body compiled as host C++ (torch_port_util.host_step),
where one thread runs each world's lane regions lane after lane.

  * Bodies built at FS_LANES = 1, at the kept LANES and at WIDE give bitwise
    the same q', u' over a few steps, on flat ANYmal, ANYmal on the trot scene's
    terrains, the sphere-box stack, the rock on terrain and a yawed cube on
    a flat field (its 4 bottom vertices equally deep: the mesh selection's
    tie). The lanes change which lane computes a value, never its
    expression, so any difference is an index mistake: an item of a lane
    region done twice or not at all, or a shared value read before it is
    written (the host fills the shared memory with NaN before each world).
    The cone solve's argmins over the lanes take here their host form, a
    serial first-match scan over the lanes' partial minima
    (torch_port_util._HOST_PRE), which the card's warp reductions must
    equal.
  * The per-world operation and height-load tallies of the six scenes are
    pinned: the lanes split the work, they do not change it.
  * The shared-memory size of a block at both widths, and its refusal above
    what a block can hold.
  * The width rule (`lanes_for`): WIDE where the batch's worlds, a warp
    each, fit the card in one wave (of at most one warp per scheduler where
    they probe a heightmap); the wide build is not built for a batch past
    what it could hold.
  * The emitter's FMAs (`_fuse_products`), and both builds registered
    without nvcc's own contraction.

Races between lanes show only on the card (tests/test_torch_cuda.py,
chip_smoke.py). The scenes are chip_smoke.py's, on the CPU, in float32."""

import numpy as np
import pytest
import torch

from torch_port_util import host_step, load_chip_smoke, load_golden, perturbed_states
from torch_port_util import one_thread  # noqa: F401  (a module fixture)

CS = load_chip_smoke()
TROT = load_golden("anymal_trot_heightmap.npz")
B = 8
# operations and height loads per world of each scene's source (chip_smoke.py)
TALLIES = {"flat": (337307, 0), "terrain": (345175, 304), "stack": (239231, 0),
           "cylinder": (141207, 24), "cone": (94291, 16), "rock": (99738, 128)}


def _scene(name):
  """(scene, use_pd) of chip_smoke.py's scene `name`, on the CPU."""
  if name == "flat":
    return CS.anymal_scene(torch, device="cpu"), True
  if name == "terrain":                # the trot golden's scene
    return CS.anymal_scene(torch, dt=float(TROT["dt"]), kp=float(TROT["kp"]),
                           kd=float(TROT["kd"]), device="cpu", terrain=True), True
  if name == "stack":
    return CS.stack_scene(torch, device="cpu"), False
  return CS.debris_scene(torch, "mesh" if name == "rock" else name, device="cpu"), False


def _sd(scene, use_pd):
  from raisimlib_torch.ops import gpu_step, pipeline

  return gpu_step._analyze(scene, pipeline.StepConfig(), use_pd)


def _states(name, scene):
  """(q, u, pd, heights or None, steps) for the bitwise comparison: states
  in which the scene's contacts act within the steps."""
  if name in ("flat", "terrain"):     # around a golden's settled state, feet down
    g = TROT if name == "terrain" else load_golden()
    q, u = perturbed_states(g, B, seed=60)
    pd = torch.tensor(np.tile(g["pd_targets"][0], (B, 1)))
    hts = None
    if name == "terrain":            # each world on its own terrain
      hts = torch.tensor(g["heights"][None] + 0.02 * np.random.RandomState(61).randn(B, 48, 24))
    return torch.tensor(q), torch.tensor(u), pd, hts, 6
  if name == "stack":          # the sphere lands on the sliding box in about 40 steps
    s = CS.loose_states(torch, scene, B, seed=62, kick=(3, CS.STACK["kick_m_s"]))
    return s.q, s.u, torch.zeros_like(s.u), None, 60
  if name == "rock":           # a drop of 0.25-0.45 m lands in 90-150 steps
    hts = CS.make_terrains(torch, B, device="cpu")
    s = CS.debris_states(torch, scene, hts, seed=63)
    return s.q, s.u, torch.zeros_like(s.u), hts, 200
  hts = torch.zeros((B, 48, 24))   # the cube upright, 1 mm deep: 4 vertices tie
  s = CS.upright_states(torch, scene, "cube", B, seed=64)
  return s.q, s.u, torch.zeros_like(s.u), hts, 4


def _roll(host, q, u, pd, hts, steps):
  """`steps` steps of a host body from (q, u): the final (q, u)."""
  q, u, pd = (np.ascontiguousarray(x.numpy(), np.float32) for x in (q, u, pd))
  h = None if hts is None else np.ascontiguousarray(hts.numpy(), np.float32)
  tau = np.zeros_like(u)
  for _ in range(steps):
    qo, uo = np.zeros_like(q), np.zeros_like(u)
    host(q.ctypes.data, u.ctypes.data, tau.ctypes.data, pd.ctypes.data,
         None if h is None else h.ctypes.data, 0 if h is None else h[0].size,
         qo.ctypes.data, uo.ctypes.data, B)
    q, u = qo, uo
  return q, u


@pytest.mark.parametrize("name", ["flat", "terrain", "stack", "rock", "cube"])
def test_lane_counts_agree_bitwise(name, tmp_path):
  """Host bodies at FS_LANES = 1, at LANES and at WIDE: the same q', u',
  bit for bit, after each scene's steps, with its contacts acting (in at
  least 6 of the 8 worlds at the end)."""
  from raisimlib_torch.ops import collision as coll
  from raisimlib_torch.ops import dynamics, gpu_step

  scene, use_pd = _scene(name)
  sd = _sd(scene, use_pd)
  q, u, pd, hts, steps = _states(name, scene)
  out = [_roll(host_step(sd, tmp_path, lanes=n, opt="-O0"), q, u, pd, hts, steps)
         for n in (1, gpu_step.LANES, gpu_step.WIDE)]
  q1, u1 = out[0]
  assert np.isfinite(q1).all() and np.isfinite(u1).all()
  for qg, ug in out[1:]:
    assert np.array_equal(q1, qg) and np.array_equal(u1, ug)
  field = None if hts is None else scene.field.replace(heights=hts.float())
  c = coll.collide(scene.geoms, scene.pairs, dynamics.fk(scene.model, torch.tensor(q1)), field)
  assert float(c.active.float().amax(1).mean()) >= 0.75    # the contacts act


def test_tallies_are_pinned():
  """The six scenes' operation and height-load tallies per world, as the
  source reports them: the lanes split the work and leave it whole."""
  from raisimlib_torch.ops import gpu_step

  for name, tally in TALLIES.items():
    _, ops, loads = gpu_step.kernel_source(_sd(*_scene(name)))
    assert (ops, loads) == tally, name


def test_shared_memory_per_block():
  """Flat ANYmal: 1300 floats per world (the 49 columns of W and v_free, 264
  slots of J, 12 x 6 of Gii, z, 32 sines and cosines), 4 worlds a block at
  8 lanes and one at 32, as the sources say, which differ only in their
  lane count and register cap; a block of 16 two-lane worlds (above 48 KB,
  dynamic) fits, and a scene whose block would need more than 227 KB is
  refused. The register cap of 128 (16 blocks an SM) goes to the stack,
  whose blocks 16 fit in an SM's shared memory, and not to ANYmal."""
  from raisimlib_torch.ops import gpu_step

  sd = _sd(*_scene("flat"))
  per_world = 49 * 18 + 264 + 12 * 6 + 18 + 2 * 32
  assert gpu_step.LANES == 8 and gpu_step.smem_bytes(sd) == 4 * 4 * per_world
  assert gpu_step.WIDE == 32 and gpu_step.smem_bytes(sd, gpu_step.WIDE) == 4 * per_world
  src = gpu_step.kernel_source(sd)[0]
  assert f"#define FS_SMEM_WORLD {per_world}\n" in src and f"#define FS_LANES {gpu_step.LANES}\n" in src
  lines = [ln.strip() for ln in src.splitlines()]
  assert lines.count("FS_LANES_BEGIN") == lines.count("FS_LANES_END") > 1
  wide = gpu_step.kernel_source(sd, gpu_step.WIDE)[0]
  cap = gpu_step.min_blocks(sd, gpu_step.WIDE)
  assert wide == src.replace(f"#define FS_LANES {gpu_step.LANES}\n",
                             f"#define FS_LANES {gpu_step.WIDE}\n").replace(
      "#define FS_MIN_BLOCKS 1\n", f"#define FS_MIN_BLOCKS {cap}\n")
  assert 48 * 1024 < gpu_step.smem_bytes(sd, 2) <= gpu_step.SMEM_BLOCK_LIMIT
  wide = sd._replace(slots=sd.slots * 30)                  # 360 contact slots
  with pytest.raises(gpu_step.FusedStepUnsupported, match="shared memory"):
    gpu_step.smem_bytes(wide)
  with pytest.raises(gpu_step.FusedStepUnsupported, match="shared memory"):
    gpu_step.kernel_source(wide)
  assert gpu_step.min_blocks(sd) == 1 and "#define FS_MIN_BLOCKS 1\n" in src
  assert gpu_step.min_blocks(_sd(*_scene("stack"))) == 16


@pytest.mark.parametrize("B, blocks_per_sm, lanes", [
    (1, 8, 32), (4, 8, 32), (128, 8, 32), (384, 8, 32), (1024, 8, 32), (1056, 8, 32),
    (1057, 8, 8), (2048, 8, 8), (2048, 16, 32), (16384, 8, 8), (16384, 64, 8)])
def test_width_rule(B, blocks_per_sm, lanes):
  """`lanes_for` on an H100's 132 SMs: 32 lanes where the B worlds, one warp
  each, fit the card in one wave of the wide build's blocks (1056 worlds at
  8 blocks an SM), else 8."""
  from raisimlib_torch.ops import gpu_step

  assert gpu_step.lanes_for(B, 132, blocks_per_sm) == lanes


@pytest.mark.parametrize("B, blocks_per_sm, lanes", [
    (1, 8, 32), (384, 8, 32), (528, 8, 32), (529, 8, 8), (768, 8, 8), (1024, 8, 8),
    (264, 2, 32), (265, 2, 8), (16384, 8, 8)])
def test_width_rule_on_heightmaps(B, blocks_per_sm, lanes):
  """`lanes_for` where the worlds probe a heightmap: the wave holds at most
  one warp per scheduler, 4 an SM (528 worlds on 132 SMs), and no more than
  the wide build's blocks; ANYmal on terrain (K1c) thus takes 32 lanes at
  the trot MPPI's B = 384 and 8 at 768 and 1024."""
  from raisimlib_torch.ops import gpu_step

  assert gpu_step.lanes_for(B, 132, blocks_per_sm, probes=True) == lanes
  kern = gpu_step.FusedKernel(_sd(*_scene("terrain")))
  assert kern.loads_per_world > 0


@pytest.mark.parametrize("lines, fused", [
    (["float t1 = a * b;", "float t2 = t1 + c;"], ["float t2 = fmaf(a, b, c);"]),
    (["float t1 = a * b;", "float t2 = t1 - c;"], ["float t2 = fmaf(a, b, -(c));"]),
    (["float t1 = a * b;", "float t2 = c - t1;"], ["float t2 = fmaf(-(a), b, c);"]),
    (["float t1 = a * b;", "float t3 = c * d;", "float t4 = t1 + t3;"],
     ["float t1 = a * b;", "float t4 = fmaf(c, d, t1);"]),
    (["float t1 = a * b;", "float t5 = sqrtf(e);", "bool t6 = t5 < a;", "float t2 = t1 + t5;"],
     ["float t5 = sqrtf(e);", "bool t6 = t5 < a;", "float t2 = fmaf(a, b, t5);"]),
    (["float t1 = a * b;", "float t2 = t1 + c;", "float t3 = t1 + d;"], None),
    (["float t1 = z[0] * b;", "z[0] = c;", "float t2 = t1 + c;"], None),
    (["float t1 = a * b;", "if (l == 0) {", "  float t2 = t1 + c;", "}"], None),
])
def test_products_fuse_into_their_one_sum(lines, fused):
  """`_fuse_products`: a product that one sum or difference reads, and
  nothing else, becomes an fmaf there (of two, the second), where only
  definitions lie between them; a product read twice, or one whose
  operands a store or a brace may change or hide, stays (None: the lines
  unchanged)."""
  from raisimlib_torch.ops import gpu_step

  assert gpu_step._fuse_products(lines) == (lines if fused is None else fused)


def test_builds_compile_without_contraction(monkeypatch):
  """Both builds of a scene compile with --fmad=false, so that their only
  FMAs are the source's; `_build.build()` compiles the narrow build with
  the other kernels and leaves the wide one to its first launch."""
  from raisimlib_torch import _build
  from raisimlib_torch.ops import gpu_step

  kern = gpu_step.FusedKernel(_sd(*_scene("flat")))
  assert kern.source.count("fmaf(") > 3000
  for lanes, lazy in ((gpu_step.LANES, False), (gpu_step.WIDE, True)):
    spec = _build.KERNELS[kern.names[lanes]]
    assert spec["defines"] == ("--fmad=false",) and spec["lazy"] == lazy
  started = []

  class Nvcc:
    returncode = 1

    def __init__(self, cmd, **_):
      started.append(cmd[-1])

    def communicate(self):
      return "", None

  monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
  monkeypatch.setattr(_build.subprocess, "Popen", Nvcc)
  monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
  with pytest.raises(RuntimeError, match="nvcc failed"):
    _build.build()
  assert _build.KERNELS[kern.names[gpu_step.LANES]]["source"] in started
  assert _build.KERNELS[kern.names[gpu_step.WIDE]]["source"] not in started


def test_wide_build_waits_past_its_bound(monkeypatch):
  """`FusedKernel.lanes` on a card of 132 SMs: a batch past what the wide
  build could hold in one wave before its registers count (32 blocks an
  SM for ANYmal, of the 37 that its shared memory allows) takes 8 lanes
  without loading the wide build; below it, the build's blocks per SM
  (here 8) decide, read once."""
  import types

  from raisimlib_torch import _build
  from raisimlib_torch.ops import gpu_step

  kern = gpu_step.FusedKernel(_sd(*_scene("flat")))
  loaded = []

  def query(ref):
    ref._obj.value = 8
    return 0

  def load(name):
    loaded.append(name)
    return types.SimpleNamespace(fused_step_blocks_per_sm=query)

  props = types.SimpleNamespace(multi_processor_count=132, max_threads_per_multi_processor=2048)
  monkeypatch.setattr(torch.cuda, "get_device_properties", lambda d: props)
  monkeypatch.setattr(torch.cuda, "device", lambda d: __import__("contextlib").nullcontext())
  monkeypatch.setattr(_build, "load", load)
  assert gpu_step.SM_SMEM // (gpu_step.smem_bytes(kern.sd, gpu_step.WIDE) + 1024) == 37
  assert kern.lanes(16384, "card") == kern.lanes(132 * 32 + 1, "card") == gpu_step.LANES
  assert loaded == []
  assert kern.lanes(132 * 32, "card") == gpu_step.LANES
  assert kern.lanes(1056, "card") == kern.lanes(1, "card") == gpu_step.WIDE
  assert loaded == [kern.names[gpu_step.WIDE]]
