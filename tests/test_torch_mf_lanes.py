"""K2's lanes (the matrix-free solve, csrc/mf_solve.cuh + mf_solve.cu, and
its wrapper ops/gpu_contact.py), on the CPU: the world's body and the
kernel's frame built as host C++ (torch_port_util.host_mf), where one thread
runs each world's lane regions lane after lane, and each block's shared
memory is filled with NaN first.

  * Bodies built at 1 lane and at G lanes give bitwise the same u and lam.
    The lanes change
    which lane computes a value, never its expression, so a difference is an
    index mistake: an item of a lane region done twice or not at all, or a
    shared value read before it is written (it would read NaN).
  * The body against the plain twin `_mf_plain`, at chip_smoke.py's tiers
    (check_kernel): >= 99% of lam within 1e-4 of the impulse scale, all
    within 3e-2, and an objective no worse than 2e-3 relative; on the ANYmal
    factors, on random problems with lin and bilateral rows, on a ragged
    batch and at nc 48, nv 64.
  * The kernel's choice of worlds per block, shared-memory size and layout
    (`mf_block`, which csrc/mf_solve.cu's launch calls): the rows staged in
    shared memory where one world's fit, else read from device memory; its
    refusal where not even one world's small arrays fit; the wrapper's row
    table, and its batch-first inputs (no copy of a contiguous float32
    input).
  * The device-memory layout (a build with MF_DEVICE_ROWS takes it wherever
    it fits) gives the staged layout's u and lam bit for bit, and takes
    over between 6 and 7 free boxes on the ground (box-box pairs, 9 slots
    each), where it holds the twin's tiers.

Races between lanes show only on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

import ctypes

import numpy as np
import pytest
import torch

from torch_port_util import anymal_factors, host_mf
from torch_port_util import one_thread  # noqa: F401  (a module fixture)

from raisimlib_torch import _build
from raisimlib_torch.ops import contact as ct
from raisimlib_torch.ops import gpu_contact as gc

LANE_COUNTS = [4, 8, 16]


@pytest.fixture(scope="module")
def hosts(tmp_path_factory):
  """Host builds by lane count, made at first use."""
  tmp = tmp_path_factory.mktemp("mf_host")
  cache = {}

  def get(lanes):
    if lanes not in cache:
      cache[lanes] = host_mf(tmp, lanes, opt="-O0")
    return cache[lanes]

  return get


def random_problem(B, nc, seed, kinds=(), nv=None):
  """chip_smoke.py's random problem in numpy (float32): J random, W = J M^-1
  for a random SPD M, 30% of rows inactive; lin rows keep only their third
  component, bilateral rows have mu = 1e7 (the sentinel)."""
  rng = np.random.default_rng(seed)
  nv = 3 * nc + 4 if nv is None else nv
  Jr = rng.standard_normal((B, nc, 3, nv))
  A = rng.standard_normal((B, nv, nv))
  M = A @ A.transpose(0, 2, 1) + 3.0 * np.eye(nv)
  Wt = (Jr.reshape(B, 3 * nc, nv) @ np.linalg.inv(M)).reshape(Jr.shape)
  vf = rng.standard_normal((B, nv))
  bias = np.zeros((B, nc, 3))
  mu = 0.3 + 0.9 * rng.random((B, nc))
  active = (rng.random((B, nc)) > 0.3).astype(np.float64)
  for i, k in enumerate(kinds):
    if k == "lin":
      Jr[:, i, :2] = 0.0
      Wt[:, i, :2] = 0.0
      mu[:, i] = 0.0
    elif k == "bilateral":
      mu[:, i] = 1e7
  return [x.astype(np.float32) for x in (Jr, Wt, vf, bias, mu, active)], tuple(kinds)


def problem(name):
  """(inputs, row kinds) of a named case."""
  if name == "anymal":                 # 12 cone + 12 lin rows, nv = 18
    return anymal_factors(12, seed=3)
  if name == "lin_bilateral":
    return random_problem(9, 4, 7, ("cone", "lin", "cone", "bilateral"))
  if name == "mixed_nc12":
    return random_problem(6, 12, 8, ("cone", "lin", "bilateral") * 4)
  return random_problem(9, int(name.split("nc")[1]), 5)


def block(host, nc, nv, kinds, n_grid=32):
  """(worlds per block, shared bytes per block) of the build `host`."""
  return block_layout(host, nc, nv, kinds, n_grid)[:2]


def block_layout(host, nc, nv, kinds, n_grid=32):
  """(worlds per block, shared bytes per block, layout: "shared" or
  "device") of the build `host`."""
  nbytes, staged = ctypes.c_int(0), ctypes.c_int(0)
  wpb = host.host_mf_block(nc, nv, gc._used_rows(kinds), n_grid, ctypes.byref(nbytes),
                           ctypes.byref(staged))
  return wpb, nbytes.value, "shared" if staged.value else "device"


def run_host(host, args, kinds, B=None):
  """The host kernel on the first B worlds of args; (u, lam) with 4 spare
  rows each, NaN unless stored."""
  B = args[0].shape[0] if B is None else B
  _, nc, _, nv = args[0].shape
  ins = [np.ascontiguousarray(a[:B], np.float32) for a in args]
  kinds = kinds or ("cone",) * nc
  rows = gc._row_table(kinds, "cpu").numpy()
  u = np.full((B + 4, nv), np.nan, np.float32)
  lam = np.full((B + 4, nc, 3), np.nan, np.float32)
  cfg = ct.SolverConfig()
  host.host_mf(*(x.ctypes.data for x in ins), rows.ctypes.data, u.ctypes.data,
               lam.ctypes.data, B, nc, nv, gc._used_rows(kinds), cfg.sweeps, cfg.n_grid)
  return u, lam


def assert_within_tiers(args, kinds, u, lam):
  """chip_smoke.py's check_kernel tiers against `_mf_plain`."""
  B = args[0].shape[0]
  xs = [torch.tensor(a) for a in args]
  cfg = ct.SolverConfig(row_kinds=kinds or None)
  up, lp = (x.numpy() for x in gc._mf_plain(*xs, cfg))
  assert np.isfinite(u[:B]).all() and np.isfinite(lam[:B]).all()
  scale = np.abs(lp).max() + 1.0
  rel = np.abs(lam[:B] - lp) / scale
  assert (rel < 1e-4).mean() >= 0.99 and rel.max() < 3e-2
  Jr, Wt, vf, bias = (a.astype(np.float64) for a in args[:4])
  _, nc, _, nv = Jr.shape
  Jf, Wf = Jr.reshape(B, 3 * nc, nv), Wt.reshape(B, 3 * nc, nv)
  G = Jf @ Wf.transpose(0, 2, 1)
  c = (Jf @ vf[:, :, None])[:, :, 0] - bias.reshape(B, -1)

  def energy(x):
    x = x.astype(np.float64).reshape(B, -1)
    return 0.5 * np.einsum("bi,bij,bj->b", x, G, x) + (c * x).sum(1)

  Ek, Ep = energy(lam[:B]), energy(lp)
  assert ((Ek - Ep) / (np.abs(Ep) + 1.0)).max() <= 2e-3
  assert np.abs(u[:B] - up).max() < 3e-2 * (np.abs(up).max() + 1.0)


@pytest.mark.parametrize("lanes", LANE_COUNTS)
@pytest.mark.parametrize("name", ["anymal", "lin_bilateral", "mixed_nc12"])
def test_lane_counts_agree_bitwise(name, lanes, hosts):
  """Bodies at 1 lane and at `lanes`: the same u and lam, bit for bit, and
  finite (no shared value read before it was written)."""
  args, kinds = problem(name)
  u1, l1 = run_host(hosts(1), args, kinds)
  ug, lg = run_host(hosts(lanes), args, kinds)
  B = args[0].shape[0]
  assert np.isfinite(u1[:B]).all() and np.isfinite(l1[:B]).all()
  assert np.array_equal(u1, ug, equal_nan=True) and np.array_equal(l1, lg, equal_nan=True)


@pytest.mark.parametrize("name", ["anymal", "nc1", "nc4", "nc12", "lin_bilateral",
                                  "mixed_nc12"])
def test_body_matches_plain_twin(name, hosts):
  """The body at the kept build (`_build.MF_LANES` lanes) against
  `_mf_plain`, within chip_smoke.py's tiers."""
  args, kinds = problem(name)
  u, lam = run_host(hosts(_build.MF_LANES), args, kinds)
  assert_within_tiers(args, kinds, u, lam)


def test_ragged_batch(hosts):
  """B = 7 in blocks of 2 worlds (16 lanes each, the kept build) and of 4
  (8 lanes): the last block's spare world computes on world 6 and stores
  nothing (the rows past B keep their NaN), and each world is bitwise the
  same world of the batch of 12 and of a batch of 1."""
  args, kinds = problem("anymal")
  for lanes, wpb in ((_build.MF_LANES, 2), (8, 4)):
    host = hosts(lanes)
    assert block(host, 24, 18, kinds)[0] == wpb
    u12, l12 = run_host(host, args, kinds)
    u7, l7 = run_host(host, args, kinds, B=7)
    assert np.isnan(u7[7:]).all() and np.isnan(l7[7:]).all()
    assert np.array_equal(u7[:7], u12[:7]) and np.array_equal(l7[:7], l12[:7])
    u1, l1 = run_host(host, [a[6:] for a in args], kinds, B=1)
    assert np.array_equal(u1[:1], u12[6:7]) and np.array_equal(l1[:1], l12[6:7])
  assert_within_tiers([a[:7] for a in args], kinds, u7, l7)


def test_cap_shape(hosts):
  """nc = 48 cone rows and nv = 64, the one-thread kernel's caps: 3 worlds a
  block at 8 lanes (4 would pass 227 KB), 1 lane and 8 lanes bitwise equal,
  and within the tiers of the twin."""
  args, kinds = random_problem(3, 48, 9, nv=64)
  assert block(hosts(8), 48, 64, ("cone",) * 48) == (3, 3 * 4 * 19296)
  u8, l8 = run_host(hosts(8), args, kinds)
  u1, l1 = run_host(hosts(1), args, kinds)
  assert np.array_equal(u8, u1, equal_nan=True) and np.array_equal(l8, l1, equal_nan=True)
  assert_within_tiers(args, kinds, u8, l8)


def test_block_shape_and_row_table(hosts):
  """The kernel's worlds per block and shared bytes (`mf_block`, through the
  host builds): ANYmal 2164 floats a world (48 used rows of 18), 2 worlds a
  block at the kept 16 lanes, 4 at 8, 8 at 4; at the caps (nc 48, nv 64,
  19,296 floats) 2 at 16 lanes and 3 at 8 (4 would pass 227 KB); at nv 100
  one world, a half warp at 16 lanes; at nc 100, nv 128 (one world's rows
  pass 227 KB) the device-memory layout, 1,720 floats a world, 2 a block;
  none where not even one world's small arrays fit (nc 4200: the launch
  refuses it, and the wrapper raises). The row table: kinds, each solver
  row's first staged row, each staged row's input row."""
  kinds = ("cone",) * 12 + ("lin",) * 12
  table = gc._row_table(kinds, "cpu").tolist()
  assert table[:24] == [0] * 12 + [1] * 12
  assert table[24:48] == [3 * i for i in range(12)] + [36 + i for i in range(12)]
  assert table[48:] == list(range(36)) + [3 * i + 2 for i in range(12, 24)]
  assert gc._used_rows(kinds) == 48
  assert _build.MF_LANES == 16
  for lanes, wpb in ((16, 2), (8, 4), (4, 8)):
    assert block(hosts(lanes), 24, 18, kinds) == (wpb, wpb * 4 * 2164)
  cone48 = ("cone",) * 48
  assert block(hosts(16), 48, 64, cone48) == (2, 2 * 4 * 19296)
  assert block_layout(hosts(16), 48, 100, cone48) == (1, 4 * 29736, "shared")
  assert block_layout(hosts(16), 100, 128, ("cone",) * 100) == (2, 2 * 4 * 1720, "device")
  assert block(hosts(16), 4200, 8, ("cone",) * 4200) == (0, 0)


def test_kernel_inputs_are_batch_first():
  """kernel_inputs hands contiguous float32 inputs over as they are (the
  same storage), converts a bool `active` to float32, and copies only a
  view that is not contiguous."""
  args, kinds = problem("anymal")
  xs = [torch.tensor(a) for a in args]
  xs[5] = xs[5] > 0.5
  cfg = ct.SolverConfig(row_kinds=kinds)
  ins, rows = gc.kernel_inputs(*xs, cfg)
  assert all(a.data_ptr() == b.data_ptr() for a, b in zip(ins[:5], xs[:5]))
  assert ins[5].dtype == torch.float32 and torch.equal(ins[5], xs[5].float())
  assert rows.dtype == torch.int32 and rows.shape == (96,)
  wide = torch.cat([xs[0], xs[0]], 3)[..., ::2]                  # a strided view
  ins2, _ = gc.kernel_inputs(wide, *xs[1:], cfg)
  assert ins2[0].is_contiguous() and torch.equal(ins2[0], wide)


@pytest.fixture(scope="module")
def device_host(tmp_path_factory):
  """The kept build (`_build.MF_LANES` lanes) with MF_DEVICE_ROWS: the
  device-memory layout at every shape."""
  return host_mf(tmp_path_factory.mktemp("mf_host_dev"), _build.MF_LANES, opt="-O0",
                 device_rows=True)


@pytest.mark.parametrize("name", ["anymal", "lin_bilateral", "mixed_nc12"])
def test_device_layout_matches_staged_bitwise(name, hosts, device_host):
  """The J and W rows read from device memory (mf_world<false>) give the
  staged layout's u and lam bit for bit: the same expressions on the same
  values, with only the small arrays in (NaN-filled) shared memory."""
  args, kinds = problem(name)
  nc, nv = args[0].shape[1], args[0].shape[3]
  assert block_layout(device_host, nc, nv, kinds or ("cone",) * nc)[2] == "device"
  assert block_layout(hosts(_build.MF_LANES), nc, nv, kinds or ("cone",) * nc)[2] == "shared"
  us, ls = run_host(hosts(_build.MF_LANES), args, kinds)
  ud, ld = run_host(device_host, args, kinds)
  B = args[0].shape[0]
  assert np.isfinite(ud[:B]).all() and np.isfinite(ld[:B]).all()
  assert np.array_equal(us, ud, equal_nan=True) and np.array_equal(ls, ld, equal_nan=True)


def box_pile_shape(n):
  """(nc, nv) of n free boxes on the ground: 8 plane slots a box and 9
  box-box slots a pair, 6 dofs a box."""
  return 8 * n + 9 * n * (n - 1) // 2, 6 * n


def test_layout_boundary_between_6_and_7_boxes(hosts):
  """6 free boxes (nc 183, nv 36) stage their rows (one world a block,
  about 169 KB); 7 (nc 245, nv 42, about 261 KB of rows) take the
  device-memory layout, 2 worlds a block; and the 7-box shape's random
  problem through the device layout holds the twin's tiers."""
  host = hosts(_build.MF_LANES)
  nc6, nv6 = box_pile_shape(6)
  wpb, nbytes, layout = block_layout(host, nc6, nv6, ("cone",) * nc6)
  assert (wpb, layout) == (1, "shared") and 160_000 < nbytes < 175_000
  nc7, nv7 = box_pile_shape(7)
  wpb, nbytes, layout = block_layout(host, nc7, nv7, ("cone",) * nc7)
  assert (wpb, layout) == (2, "device") and nbytes == 2 * 4 * (2 * nv7 + 14 * nc7 + 64)
  args, kinds = random_problem(2, nc7, 11, nv=nv7)
  u, lam = run_host(host, args, kinds)
  assert_within_tiers(args, kinds, u, lam)
