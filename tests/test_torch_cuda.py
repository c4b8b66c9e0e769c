"""Tests that need the card: the hand-written CUDA kernels (K2, also at
batches whose last block is partly empty, in its device-memory layout at the
shapes of 7 and 8 free boxes on the ground and where not even one world's
small arrays fit a block, and the fused step K1 on the
plane, on a heightmap, with the sphere pairs and with loose cylinders, cones
and meshes on a heightmap, Atlas at nv = 29, the iLQR scene at the FD
batch of 39,200 worlds, and at batches whose last warp is partly empty)
against their plain PyTorch twins on the GPU. They skip without a CUDA device. JAX
is not needed,
so on the GPU machine they run without the JAX test configuration:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance: the two-tier check of tests/test_pallas_contact.py (>= 99% of lam
entries within 1e-4 of the impulse scale, all within 3e-2; for K2 also u
within 3e-2 of its scale, as chip_smoke.py): the kernel and its
twin run the same algorithm in float32 with different operation orders (FMA
contraction, reduction order), and a near-tie of the angular grid's argmin
can pick a neighbouring angle."""

import pytest
import torch

from torch_port_util import (anymal_factors, load_chip_smoke, load_golden, perturbed_states,
                             torch_anymal_scene)


@pytest.mark.cuda
def test_mf_solve_kernel_matches_plain_twin():
  """The CUDA kernel against `_mf_plain` on the card (chip_smoke.py runs the
  same check at the main path's shapes)."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device: the kernel has no CPU mode")
  from raisimlib_torch.ops import contact as tct
  from raisimlib_torch.ops import gpu_contact as tgc

  args, kinds = anymal_factors(1037)
  xs = [torch.tensor(a, device="cuda") for a in args]
  cfg = tct.SolverConfig(row_kinds=kinds)
  n0 = tgc.solve_dynamics_batch.launches
  uk, lk = tgc.solve_dynamics_batch(*xs, cfg)
  up, lp = tgc._mf_plain(*xs, cfg)
  torch.cuda.synchronize()
  assert tgc.solve_dynamics_batch.launches == n0 + 1
  scale = float(lp.abs().max()) + 1.0
  rel = ((lk - lp).abs() / scale).cpu().numpy()
  assert (rel < 1e-4).mean() >= 0.99 and rel.max() < 3e-2
  assert float((uk - up).abs().max()) < 3e-2 * (float(up.abs().max()) + 1.0)


@pytest.mark.cuda
def test_fused_step_kernel_matches_plain_twin():
  """The fused full-step kernel (K1) against `_fused_plain` on the card, at
  B = 1037 (not a multiple of the block), through make_step_batch_fused.
  Two tiers per world, as chip_smoke.py's phase 7: 99% of worlds within
  2e-5 on q and 2e-4 on u (float32 rounding and FMA contraction, amplified
  by the Gauss-Seidel sweeps), every world within 5e-4 and 5e-3."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device: the kernel has no CPU mode")
  import numpy as np

  from raisimlib_torch.ops import gpu_step
  from raisimlib_torch.ops.integrator import State

  g = load_golden()
  step = gpu_step.make_step_batch_fused(torch_anymal_scene(dtype=torch.float32,
                                                           device="cuda"))
  q, u = perturbed_states(g, 1037, seed=11)
  f32 = dict(dtype=torch.float32, device="cuda")
  pd = torch.tensor(np.tile(g["pd_targets"][0], (1037, 1)), **f32)
  tau = torch.zeros_like(pd)
  s = State(q=torch.tensor(q, **f32), u=torch.tensor(u, **f32), t=torch.zeros(1037, **f32))
  n0 = gpu_step.make_step_batch_fused.launches
  with torch.inference_mode():
    sk = step(s, tau, pd)
    qp, up = gpu_step._fused_plain(step.sd, s.q, s.u, tau, pd)
  torch.cuda.synchronize()
  assert gpu_step.make_step_batch_fused.launches == n0 + 1
  dq = (sk.q - qp).abs().amax(1).cpu().numpy()
  du = (sk.u - up).abs().amax(1).cpu().numpy()
  assert ((dq <= 2e-5) & (du <= 2e-4)).mean() >= 0.99
  assert dq.max() <= 5e-4 and du.max() <= 5e-3


@pytest.mark.cuda
def test_terrain_fused_step_kernel_matches_plain_twin():
  """K1c (ANYmal on the trot golden's heightmap) against `_fused_plain` on
  the card, at B = 1037, each world on its own terrain (the golden's heights
  plus 2 cm of noise), and once more with every world on the scene's field
  (heights expanded, world stride 0). The tiers of the plane case."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device: the kernel has no CPU mode")
  import numpy as np

  from raisimlib_torch.models import anymal
  from raisimlib_torch.models.urdf import load_urdf
  from raisimlib_torch.ops import gpu_step
  from raisimlib_torch.ops.integrator import State
  from raisimlib_torch.utils import terrain
  from raisimlib_torch.world import World

  g = load_golden("anymal_trot_heightmap.npz")
  bodies, geoms, _ = load_urdf(anymal.anymal_urdf())
  world = World(dt=float(g["dt"]), dtype=torch.float32, device="cuda")
  world.add_articulated_system(bodies, name="anymal", geoms=geoms)
  world.add_heightmap(terrain.flat(0.0, size=(12.0, 6.0), samples=(48, 24), device="cuda"))
  scene = world.compile().set_pd_gains(float(g["kp"]), float(g["kd"]))
  scene = scene.replace(field=scene.field.replace(
      heights=torch.tensor(g["heights"], dtype=torch.float32, device="cuda")))
  step = gpu_step.make_step_batch_fused(scene)
  B = 1037
  f32 = dict(dtype=torch.float32, device="cuda")
  q, u = perturbed_states(g, B, seed=12)
  hts = g["heights"][None] + 0.02 * np.random.RandomState(12).randn(B, 48, 24)
  pd = torch.tensor(np.tile(g["pd_targets"][0], (B, 1)), **f32)
  tau = torch.zeros_like(pd)
  s = State(q=torch.tensor(q, **f32), u=torch.tensor(u, **f32), t=torch.zeros(B, **f32))
  for h in (torch.tensor(hts, **f32), None):
    n0 = gpu_step.make_step_batch_fused.launches
    with torch.inference_mode():
      sk = step(s, tau, pd, field_heights=h)
      qp, up = gpu_step._fused_plain(step.sd, s.q, s.u, tau, pd, step.heights(s.q, h))
    torch.cuda.synchronize()
    assert gpu_step.make_step_batch_fused.launches == n0 + 1
    dq = (sk.q - qp).abs().amax(1).cpu().numpy()
    du = (sk.u - up).abs().amax(1).cpu().numpy()
    assert ((dq <= 2e-5) & (du <= 2e-4)).mean() >= 0.99
    assert dq.max() <= 5e-4 and du.max() <= 5e-3


@pytest.mark.cuda
def test_k1b_fused_step_kernel_matches_plain_twin():
  """K1b (the sphere pairs) against `_fused_plain` on the card, B = 1037:
  the sphere-box stack settled (the golden's step 300) with its box kicked
  0.3 m/s, and a sphere on a static box ("sb" with body_b = -1), both with
  noise (1e-3 on q, 1e-2 on u). The tiers of the plane case."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device: the kernel has no CPU mode")
  import importlib.util
  import os

  import numpy as np

  from raisimlib_torch.ops import gpu_step

  path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "chip_smoke.py")
  spec = importlib.util.spec_from_file_location("chip_smoke", path)
  cs = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(cs)
  g = load_golden("sphere_box_stack.npz")
  B = 1037
  for scene in (cs.stack_scene(torch, device="cuda"), cs.static_box_scene(torch, device="cuda")):
    step = gpu_step.make_step_batch_fused(scene, use_pd=False)
    s = cs.loose_states(torch, scene, B, seed=23)
    if scene.model.nq == 14:                        # the stack: start from the settled state
      s.q += torch.tensor(g["q"][300] - g["q0"], dtype=torch.float32, device="cuda")
      s.u[:, 3] += 0.3
    tau = torch.zeros_like(s.u)
    n0 = gpu_step.make_step_batch_fused.launches
    with torch.inference_mode():
      sk = step(s, tau)
      qp, up = gpu_step._fused_plain(step.sd, s.q, s.u, tau)
    torch.cuda.synchronize()
    assert gpu_step.make_step_batch_fused.launches == n0 + 1
    dq = (sk.q - qp).abs().amax(1).cpu().numpy()
    du = (sk.u - up).abs().amax(1).cpu().numpy()
    assert ((dq <= 2e-5) & (du <= 2e-4)).mean() >= 0.99
    assert dq.max() <= 5e-4 and du.max() <= 5e-3
    assert np.isfinite(dq).all()


@pytest.mark.cuda
def test_debris_fused_step_kernel_matches_plain_twin():
  """K1c's cylinder, cone and mesh slots (chip_smoke.py's debris scenes: one
  body per world on 64 fractal terrains) against `_fused_plain` on the card,
  B = 1037, from the drop states and 200 steps on (landed). The tiers of
  the plane case."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device: the kernel has no CPU mode")
  from torch_port_util import load_chip_smoke

  from raisimlib_torch.ops import gpu_step

  cs = load_chip_smoke()
  B = 1037
  hts = cs.make_terrains(torch, 64).repeat(17, 1, 1)[:B].contiguous()
  for name in cs.DEBRIS_NAMES:
    step = gpu_step.make_step_batch_fused(cs.debris_scene(torch, name), use_pd=False)
    s = cs.debris_states(torch, step.scene, hts, seed=25)
    tau = torch.zeros_like(s.u)
    with torch.inference_mode():
      for k in range(201):
        if k in (0, 200):
          n0 = gpu_step.make_step_batch_fused.launches
          sk = step(s, tau, field_heights=hts)
          qp, up = gpu_step._fused_plain(step.sd, s.q, s.u, tau, None, hts)
          torch.cuda.synchronize()
          assert gpu_step.make_step_batch_fused.launches == n0 + 1
          dq = (sk.q - qp).abs().amax(1).cpu().numpy()
          du = (sk.u - up).abs().amax(1).cpu().numpy()
          assert ((dq <= 2e-5) & (du <= 2e-4)).mean() >= 0.99, name
          assert dq.max() <= 5e-4 and du.max() <= 5e-3, name
        s = step(s, tau, field_heights=hts)


@pytest.mark.cuda
def test_atlas_fused_step_kernel_matches_plain_twin():
  """K1 at nv = 29: Atlas (the atlas_batch scenario, 32 plane_pt slots, 23
  limit rows) against `_fused_plain` on the card at B = 1037, from states
  around the Atlas golden's start. The tiers of the ANYmal case, but up to
  0.5% of worlds may pass the ceiling: a box corner within ~1e-7 m of the
  ground touches on one side of an f32 rounding and not on the other
  (chip_smoke.py, ATLAS_BRANCH_SHARE)."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device: the kernel has no CPU mode")
  import numpy as np

  from raisimlib_torch import scenarios
  from raisimlib_torch.ops import gpu_step
  from raisimlib_torch.ops.integrator import State

  g = load_golden("atlas_settle.npz")
  scene = scenarios.build_scene(scenarios.load("atlas_batch"), device="cuda")[0]
  step = gpu_step.make_step_batch_fused(scene)
  rng = np.random.RandomState(12)
  q = np.tile(g["q0"], (1037, 1)) + 1e-3 * rng.randn(1037, 30)
  q[:, 3:7] /= np.linalg.norm(q[:, 3:7], axis=1, keepdims=True)
  u = np.tile(g["u0"], (1037, 1)) + 1e-2 * rng.randn(1037, 29)
  f32 = dict(dtype=torch.float32, device="cuda")
  pd = torch.tensor(np.tile(g["pd_targets"][0], (1037, 1)), **f32)
  tau = torch.zeros_like(pd)
  s = State(q=torch.tensor(q, **f32), u=torch.tensor(u, **f32), t=torch.zeros(1037, **f32))
  with torch.inference_mode():
    sk = step(s, tau, pd)
    qp, up = gpu_step._fused_plain(step.sd, s.q, s.u, tau, pd)
  torch.cuda.synchronize()
  dq = (sk.q - qp).abs().amax(1).cpu().numpy()
  du = (sk.u - up).abs().amax(1).cpu().numpy()
  assert ((dq <= 2e-5) & (du <= 2e-4)).mean() >= 0.99
  assert ((dq > 5e-4) | (du > 5e-3)).sum() <= int(0.005 * 1037)


@pytest.mark.cuda
def test_ilqr_scene_fused_step_at_the_fd_batch():
  """The iLQR scene's K1 (ANYmal at dt = 0.01 s, mpc/balance_ilqr.py)
  against its twin at B = 39,200: the FD stack of one iteration of 8 envs x
  H = 50 (mpc/ilqr.fd_rows, fd_eps 2e-2, central), around states settled
  20 steps into a PD hold. The tiers of the plane case; two launches on the
  same inputs bitwise equal."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device: the kernel has no CPU mode")
  from raisimlib_torch.models import anymal
  from raisimlib_torch.mpc import balance_ilqr as bi
  from raisimlib_torch.mpc.ilqr import fd_rows
  from raisimlib_torch.mpc.state_map import make_contact_dyn_batch
  from raisimlib_torch.ops import gpu_step
  from raisimlib_torch.ops.integrator import State

  scene = bi.balance_scene(device="cuda")
  step = gpu_step.make_step_batch_fused(scene)
  dyn, _, _ = make_contact_dyn_batch(scene, bi.CONTROL_DT, 1, fused="require")
  x0s, U0s = (torch.tensor(a, device="cuda")
              for a in bi.balance_starts(anymal.standing_q(), 8, 50, seed=7))
  with torch.inference_mode():
    x = x0s
    for _ in range(20):
      x = dyn(x, U0s[:, 0], 0)
    xs = []
    for t in range(50):
      xs.append(x)
      x = dyn(x, U0s[:, t], t)
    Xs, Us = fd_rows(torch.stack(xs, 1).reshape(400, 37), U0s.reshape(400, 12), 2e-2, 2)
    B = Xs.shape[0]
    assert B == 39200
    pd = torch.zeros((B, 18), device="cuda")
    pd[:, 6:] = Us
    tau = torch.zeros_like(pd)
    s = State(q=Xs[:, :19].contiguous(), u=Xs[:, 19:].contiguous(),
              t=torch.zeros(B, device="cuda"))
    n0 = gpu_step.make_step_batch_fused.launches
    sk, again = step(s, tau, pd), step(s, tau, pd)
    qp, up = gpu_step._fused_plain(step.sd, s.q, s.u, tau, pd)
  torch.cuda.synchronize()
  assert gpu_step.make_step_batch_fused.launches == n0 + 2
  assert torch.equal(sk.q, again.q) and torch.equal(sk.u, again.u)
  dq = (sk.q - qp).abs().amax(1).cpu().numpy()
  du = (sk.u - up).abs().amax(1).cpu().numpy()
  assert ((dq <= 2e-5) & (du <= 2e-4)).mean() >= 0.99
  assert dq.max() <= 5e-4 and du.max() <= 5e-3


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3, 383])
def test_fused_step_tail_batches(B):
  """K1 at batches whose last warp holds fewer worlds than it has room for
  (a warp holds 32 // LANES worlds; a world past B computes on a clamped
  index and stores nothing): against the twin at the tiers of the plane
  case, bitwise equal to the same worlds launched in a batch of 1037, and
  with no store past row B (spare output rows keep their NaN)."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device: the kernel has no CPU mode")
  import numpy as np

  from raisimlib_torch import _build
  from raisimlib_torch.ops import gpu_step
  from raisimlib_torch.ops.integrator import State

  g = load_golden()
  step = gpu_step.make_step_batch_fused(torch_anymal_scene(dtype=torch.float32,
                                                           device="cuda"))
  f32 = dict(dtype=torch.float32, device="cuda")
  q, u = perturbed_states(g, 1037, seed=13)
  pd = torch.tensor(np.tile(g["pd_targets"][0], (1037, 1)), **f32)
  tau = torch.zeros_like(pd)
  s = State(q=torch.tensor(q, **f32), u=torch.tensor(u, **f32), t=torch.zeros(1037, **f32))
  with torch.inference_mode():
    full = step(s, tau, pd)
    sb = State(q=s.q[:B].contiguous(), u=s.u[:B].contiguous(), t=s.t[:B])
    sk = step(sb, tau[:B], pd[:B])
    qp, up = gpu_step._fused_plain(step.sd, sb.q, sb.u, tau[:B], pd[:B])
    qo = torch.full((B + 8, 19), float("nan"), **f32)
    uo = torch.full((B + 8, 18), float("nan"), **f32)
    rc = _build.load(step.kernel.name).fused_step_launch(
        sb.q.data_ptr(), sb.u.data_ptr(), tau.data_ptr(), pd.data_ptr(), None, 0,
        qo.data_ptr(), uo.data_ptr(), B, torch.cuda.current_stream().cuda_stream)
  torch.cuda.synchronize()
  assert rc == 0
  dq = (sk.q - qp).abs().amax(1).cpu().numpy()
  du = (sk.u - up).abs().amax(1).cpu().numpy()
  assert ((dq <= 2e-5) & (du <= 2e-4)).mean() >= 0.99
  assert dq.max() <= 5e-4 and du.max() <= 5e-3
  assert torch.equal(sk.q, full.q[:B]) and torch.equal(sk.u, full.u[:B])
  assert torch.equal(qo[:B], sk.q) and torch.equal(uo[:B], sk.u)
  assert bool(torch.isnan(qo[B:]).all()) and bool(torch.isnan(uo[B:]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3, 383])
def test_mf_solve_tail_batches(B):
  """K2 at batches whose last block holds fewer worlds than it has room for
  (a block holds 32 // MF_LANES worlds; a world past B computes on world B -
  1 and stores nothing): the tail within the two tiers of `_mf_plain`,
  bitwise equal to the same worlds of a batch of 4096, which launched twice
  gives the same bits (a race between a world's lanes would show), and no
  store past row B (spare output rows keep their NaN)."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device: the kernel has no CPU mode")
  from raisimlib_torch import _build
  from raisimlib_torch.ops import contact as tct
  from raisimlib_torch.ops import gpu_contact as tgc

  args, kinds = anymal_factors(4096, seed=14)
  xs = [torch.tensor(a, device="cuda") for a in args]
  cfg = tct.SolverConfig(row_kinds=kinds)
  with torch.inference_mode():
    u_full, l_full = tgc.solve_dynamics_batch(*xs, cfg)
    u_again, l_again = tgc.solve_dynamics_batch(*xs, cfg)
    tail = [x[:B] for x in xs]
    uk, lk = tgc.solve_dynamics_batch(*tail, cfg)
    up, lp = tgc._mf_plain(*tail, cfg)
    ins, rows = tgc.kernel_inputs(*tail, cfg)
    nc, nv = lk.shape[1], uk.shape[1]
    uo = torch.full((B + 8, nv), float("nan"), device="cuda")
    lo = torch.full((B + 8, nc, 3), float("nan"), device="cuda")
    rc = _build.load("mf_solve").mf_solve_launch(
        *(x.data_ptr() for x in ins), rows.data_ptr(), uo.data_ptr(), lo.data_ptr(), B, nc, nv,
        tgc._used_rows(kinds), cfg.sweeps, cfg.n_grid, torch.cuda.current_stream().cuda_stream)
  torch.cuda.synchronize()
  assert rc == 0
  assert torch.equal(u_full, u_again) and torch.equal(l_full, l_again)
  scale = float(lp.abs().max()) + 1.0
  rel = ((lk - lp).abs() / scale).cpu().numpy()
  assert (rel < 1e-4).mean() >= 0.99 and rel.max() < 3e-2
  assert float((uk - up).abs().max()) < 3e-2 * (float(up.abs().max()) + 1.0)
  assert torch.equal(uk, u_full[:B]) and torch.equal(lk, l_full[:B])
  assert torch.equal(uo[:B], uk) and torch.equal(lo[:B], lk)
  assert bool(torch.isnan(uo[B:]).all()) and bool(torch.isnan(lo[B:]).all())


def _mf_problem(B, nc, nv, seed):
  """A random well-posed solve on the card: J random, W = J M^-1 for a
  random SPD M (chip_smoke.random_problem's recipe), 30% of rows inactive."""
  g = torch.Generator(device="cuda").manual_seed(seed)
  f32 = dict(device="cuda", generator=g)
  Jr = torch.randn(B, nc, 3, nv, **f32)
  A = torch.randn(B, nv, nv, **f32)
  M = A @ A.transpose(-1, -2) + 3.0 * torch.eye(nv, device="cuda")
  Wt = (Jr.reshape(B, 3 * nc, nv) @ torch.linalg.inv(M)).reshape(Jr.shape)
  return [Jr, Wt, torch.randn(B, nv, **f32), torch.zeros(B, nc, 3, device="cuda"),
          0.3 + 0.9 * torch.rand(B, nc, **f32), (torch.rand(B, nc, **f32) > 0.3).float()]


def _within_tiers(xs, cfg, uk, lk):
  from raisimlib_torch.ops import gpu_contact as tgc

  up, lp = tgc._mf_plain(*xs, cfg)
  scale = float(lp.abs().max()) + 1.0
  rel = ((lk - lp).abs() / scale).cpu().numpy()
  assert bool(torch.isfinite(uk).all()) and bool(torch.isfinite(lk).all())
  assert (rel < 1e-4).mean() >= 0.99 and rel.max() < 3e-2
  assert float((uk - up).abs().max()) < 3e-2 * (float(up.abs().max()) + 1.0)


@pytest.mark.cuda
def test_mf_solve_refuses_a_world_over_a_block():
  """K2 raises, and launches nothing, only where not even one world's small
  shared arrays fit a block's 227 KB (nc 4200, nv 8); it runs nc 100, nv
  304 (rows past 227 KB; nv >= 3 nc, so that the random problem is well
  posed) in the device-memory layout, within the twin's tiers, and nc 48,
  nv 100 staged, one world a block."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device: the kernel has no CPU mode")
  from raisimlib_torch.ops import contact as tct
  from raisimlib_torch.ops import gpu_contact as tgc

  cfg = tct.SolverConfig()
  assert tgc.block_shape(4200, 8, ("cone",) * 4200, cfg.n_grid)[0] == 0
  n0 = tgc.solve_dynamics_batch.launches
  with pytest.raises(ValueError, match=r"nc=4200, nv=8.*shared memory"):
    tgc.solve_dynamics_batch(*_mf_problem(2, 4200, 8, 1), cfg)
  assert tgc.solve_dynamics_batch.launches == n0
  assert tgc.block_shape(100, 304, ("cone",) * 100, cfg.n_grid)[::2] == (2, "device")
  xs = _mf_problem(3, 100, 304, 2)
  _within_tiers(xs, cfg, *tgc.solve_dynamics_batch(*xs, cfg))
  assert tgc.block_shape(48, 100, ("cone",) * 48, cfg.n_grid)[::2] == (1, "shared")
  u, lam = tgc.solve_dynamics_batch(*_mf_problem(2, 48, 100, 3), cfg)
  torch.cuda.synchronize()
  assert bool(torch.isfinite(u).all()) and bool(torch.isfinite(lam).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n_boxes, layout", [(6, "shared"), (7, "device"), (8, "device")])
def test_mf_solve_layout_at_box_pile_shapes(n_boxes, layout):
  """K2 on the solver inputs of n boxes of chip_smoke.py's pile (8 plane
  slots a box, 9 box-box slots a pair, 6 dofs a box) 60 steps into the drop
  (the bottom boxes landed, the top ones landing), B = 67: 6 boxes stage
  their rows, 7 and 8 (about 261 and 382 KB of rows a world) read them from
  device memory. Each within the twin's tiers; tails of 1 and 3 worlds
  bitwise equal to their worlds in the batch, and the batch launched twice,
  bitwise (a race between a world's lanes would show)."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device: the kernel has no CPU mode")
  from raisimlib_torch.ops import gpu_contact as tgc
  from raisimlib_torch.ops import pipeline

  cs = load_chip_smoke()
  with torch.inference_mode():
    scene, q0, _ = cs.k2_scene(torch, "pile", n_boxes)
    s = cs.k2_states(torch, scene, q0, 67, seed=n_boxes)
    for _ in range(60):
      s = scene.step_batch(s)
    args, cfg = pipeline.solver_inputs(scene, s, torch.zeros_like(s.u))
    nc, nv = args[0].shape[1], args[0].shape[3]
    assert (nc, nv) == (8 * n_boxes + 9 * n_boxes * (n_boxes - 1) // 2, 6 * n_boxes)
    assert tgc.block_shape(nc, nv, cfg.row_kinds, cfg.n_grid)[2] == layout
    assert float(args[5].sum()) > 0.0
    uk, lk = tgc.solve_dynamics_batch(*args, cfg)
    again = tgc.solve_dynamics_batch(*args, cfg)
    tails = [tgc.solve_dynamics_batch(*[x[:b] for x in args], cfg) for b in (1, 3)]
    _within_tiers(args, cfg, uk, lk)
  torch.cuda.synchronize()
  assert torch.equal(uk, again[0]) and torch.equal(lk, again[1])
  for b, (ut, lt) in zip((1, 3), tails):
    assert torch.equal(ut, uk[:b]) and torch.equal(lt, lk[:b])
