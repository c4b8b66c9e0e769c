"""Smoke test of the PyTorch + CUDA port (raisimlib_torch) on one NVIDIA GPU.

Run from the repository root on a machine with an H100 and the CUDA toolkit:

    python3 chip_smoke.py

It builds the hand-written kernels (one nvcc per source, in parallel), then
drives the port's two main paths on the ANYmal balance configuration, the
terrain path on procedural heightmaps, the sphere-box stack (BASELINE
config 2), loose cylinders, cones and convex meshes on procedural
heightmaps, Atlas (BASELINE config 5), the port's examples at full size,
iLQR (the cartpole swing-up, BASELINE config 1, and the ANYmal balance
iLQR of bench.py, whose derivative stacks run through K1), and the scenes
outside K1's class (box stacks and piles, the support-function pairs,
compounds, wires and pins) on the K2 path, and the parallel layer at world
size 1, through their public entry points:

  1. card and build: the card's name and power limit; the kernels' build
     (K2 from csrc/mf_solve.cu; K1 generated by ops/gpu_step.py for the flat
     scene, as K1c for the terrain scenes, as K1b for the stack and phase
     18's two other scenes, as K1c for the debris scenes of phases 22-26,
     and as K1a at nv = 29 for Atlas), seconds and what ptxas says;
  K2 path (pipeline.step_batch, fused="never"):
  2. K2 against its plain twin on the card (float32): the ANYmal solver
     inputs at B = 4096, random problems with nc = 1, 4, 12, lin and
     bilateral rows, and B = 1037 (not a multiple of the block), and at the
     one-thread kernel's caps (nc = 48, nv = 64, B = 257) and past them (nv =
     100: one world a block, a partial warp; nc = 100, nv = 304: the rows
     read from device memory; nc = 4200 refused);
     then the tails (TAIL_BATCHES: the last block partly empty) against the
     twin and bitwise against the same worlds of the ANYmal batch, and that
     batch launched twice, bitwise;
  3. rollouts: Scene.step_batch, B = 16384 worlds x H = 50 steps;
  4. MPPI: mppi_step_batch over make_contact_dyn_batch(fused="never"),
     16 envs x 128 samples, H = 50, 4 substeps, 2 updates;
  5. the f32 replay of tests/goldens/anymal_balance.npz through
     Scene.step_batch, held to the batched path's gate (utils/parity.py);
  6. K2 times at the main path's shapes, B = 16384 (the rollouts), 2048
     (the MPPI batch) and 384, alone and through the wrapper, each beside
     its bound and the plain twin's time, with ptxas's figures and the
     block's shared memory;
  K1 path (the fused full step, ops/gpu_step.make_step_batch_fused, 8 lanes
  of a warp per world):
  7. K1 against its plain twin on the card, B = 4096, from perturbed standing
     states and from a state 20 steps into a rollout (contacts active), and
     against the K2 path on the same inputs; then the tails (TAIL_BATCHES:
     the last warp partly empty) against the twin and bitwise against the
     same worlds of the full batch, and the full batch twice, bitwise;
  8. rollouts through K1, B = 16384 x H = 50;
  9. MPPI through make_contact_dyn_batch(fused="require"), as phase 4;
  10. the golden replay through K1, under the same gate as phase 5;
  11. K1 times at B = 16384, 2048 (the MPPI batch), 1024 and 384, with
      ptxas's registers and spills and the block's shared memory;
  terrain (ANYmal on a 12 x 6 m heightmap of 48 x 24 samples; 12 "hm_pt"
  slots, K1c):
  12. 64 fractal terrains from utils/terrain.generate (seed 11, z_scale 0.06)
      and the K1c source's size, tally and ptxas line;
  13. K1c against its twin and against the K2 path (Scene.step_batch with
      field_heights), B = 4096, one terrain per world, from perturbed
      standing states and from 20 steps into a rollout, and its tails;
  14. terrain rollouts through K1c, B = 16384 x H = 50, the 64 terrains tiled;
  15. the trot MPPI of examples/anymal_trot_heightmap.py through
      make_contact_dyn_batch(fused="require") with env_ctx: 4 terrains x 96
      samples, H = 16, 8 substeps, 150 ticks (3 s); no robot may fall;
  16. tests/goldens/anymal_trot_heightmap.npz through K1c and through the K2
      path (80 steps, f32), under the trot gate of utils/parity.py;
  17. K1c times at B = 16384, 2048, 1024 and 384 (the trot batch);
  the sphere-box stack (raisimlib_torch/scenarios/sphere_box_stack.json, read
  into STACK; "ss", "sb" and "sc" slots, K1b):
  18. K1b against its twin and against the K2 path: the stack at B = 4096
      from the start state (box kicked 0.3 m/s, noise 1e-3 m and 1e-2 m/s)
      and 200 steps into a rollout; two spheres and a capsule ("ss", "sc")
      and a sphere on a static box ("sb", body_b = -1), B = 1037, from a
      state in which every sphere pair touches and 100 steps on; the
      stack's tails;
  19. tests/goldens/sphere_box_stack.npz (400 steps, f32) through Scene.step,
      K1b and the K2 path, under the JAX package's gate (utils/parity.py);
  20. examples/sphere_box_stack.py batched through K1b: 10 s (5000 steps)
      of 16384 kicked stacks, noise on the positions and the box's velocity
      (STACK_DQ, STACK_DU), every world held to the example's four gates;
  21. K1b times at B = 16384, 2048, 1024 and 384;
  debris on terrain (one loose cylinder, cone or 32-vertex convex rock per
  world, DEBRIS, on phase 12's 64 terrains; "hm_cylpt", "hm_conept" and
  "hm_mesh" slots, K1c):
  22. the three sources: lines, operation tally (the twin's and the
      kernel's), height loads per world, nvcc seconds and the ptxas line;
  23. each source against its twin and against the K2 path (Scene.step_batch
      with field_heights) at B = 4096, one terrain per world, from the drop
      states and 200 steps on (landed); the axis exactly vertical on a flat
      field, and a yawed cube mesh whose 4 bottom vertices tie, B = 1037;
      each scene's tails 200 steps in;
  24. rollouts of B = 16384 x H = 50 per scene;
  25. the drop settles for 500 steps (1 s) at B = 16384: every world finite,
      its COM above the surface, still over the terrain, and not sinking
      (its deepest probe, by the port's pure narrow phase, under 5 mm deep
      at one step of the last 50 at least);
  26. each source's times at B = 16384, 2048, 1024 and 384, and its bound;
  the entry points (raisimlib_torch/scenarios, raisimlib_torch/examples):
  27. the four scenarios through scenarios.build_scene; Atlas's K1 source:
      lines, operation tally (the twin's and the kernel's), nvcc seconds,
      ptxas's figures and the block's shared memory;
  28. Atlas's K1 against its twin and against the K2 path, B = 1024, from the
      example's perturbed standing states and 20 steps into a rollout; the
      tails of B = 1037, 20 steps in, and that batch launched twice, bitwise
      (ATLAS_BRANCH_SHARE says why a few worlds may pass the ceiling);
  29. tests/goldens/atlas_settle.npz (50 steps, f32) through K1 and the K2
      path, under the Atlas gate of utils/parity.py;
  30. examples.atlas_batch.run() (B = 1024 x H = 50, its gate), then Atlas's
      K1 times at B = 1024, 2048 and 16384 beside its bound;
  31. examples.anymal_balance.run(), 32. examples.anymal_trot_heightmap.run()
      and 33. examples.sphere_box_stack.run(), at full size, their gates;
  iLQR (mpc/ilqr.py; the balance problem of mpc/balance_ilqr.py, ANYmal at
  dt = 0.01 s, whose K1 source phase 1 builds with the others):
  34. examples.cartpole_swingup.run() (H = 50, 40 iterations, f32, no
      kernel), its plan within 1e-3 of tests/goldens/cartpole_swingup.npz,
      the cost within 1e-4, the pole within 0.5 rad of upright;
  35. bench.py::bench_anymal_ilqr's solve (8 envs, H = 50, 8 iterations,
      kernel-FD, fd_eps 2e-2): a warm-up, then two timed solves with
      fd_order 2 (K1 at B = 39,200 for the FD stacks, 64 for the line
      search, 8 for the rollout) and two with fd_order 1 (B = 20,000):
      iLQR solves/s, the cost ratio, K1's launches (50 + 8 x 51 a solve);
      every cost trace finite and non-increasing, the mean ratio of final to
      initial cost at most 0.5 (fd_order 2);
  36. the iLQR scene's K1 against its twin at B = 39,200 (an FD stack) and
      64 (a line-search batch), its tails, relaunched bitwise; its times at
      39,200, 20,000, 64 and 8 beside its bound, and its share of a solve;
  37. the same solve with deriv="jvp" (exact Jacobians through the pure
      path on the card; E = 2 where a solve at E = 8 would pass 60 s).
  scenes outside K1's class on the K2 path (Scene.step_batch; box-box,
  capsule-capsule, the support-function pairs, sphere-cylinder,
  sphere-mesh, a compound, wires, pins and a compliant wire; K2_PHASES):
  38. the box tower of the JAX package's tests/test_boxbox.py, B = 4096
      (x, y offsets within 5 mm), 1,000 steps: nc = 51, nv = 18, rows staged;
  39. a pile of 8 boxes, B = 1024, 750 steps: nc = 316, nv = 48, about 382
      KB of rows a world, so K2 reads them from device memory;
  40. the mixed drop onto a static box (two crossed capsules, a cylinder
      with a sphere on it, a cone, the rock, a dumbbell compound), B =
      4096, 500 steps;
  41. the stiff wire, the pin and the compliant wire of the JAX package's
      tests/test_constraints.py in one world, dt 1 ms, B = 4096 (1 cm/s
      initial velocities), 1,000 steps;
      each with its gates (k2_gates), K2 against its twin on the solver
      inputs of three steps, its tails and relaunches bitwise, and K2's
      times beside its bound and the K2 path's step.
  the parallel layer (raisimlib_torch/parallel) at world size 1, one NCCL
  rank in this process (parallel.init_distributed; the group is destroyed
  before the last line), and the checkpoint and profiling utilities
  (run_parallel; alone: tools/parallel_phases.py):
  42. parallel.make_sharded_rollout of phase 3's B = 16384 x H = 50 through
      K1 (fused="auto"), then through K2 (fused="never"): the final q and
      the q trace bitwise equal to the unsharded rollout through the same
      step, rollouts/s beside phase 8's;
  43. parallel.make_sharded_ilqr of phase 35's problem (kernel-FD through
      K1): U and costs bitwise ilqr_batch's, mean_cost and max_cost its
      mean and max; solves/s;
  44. parallel.make_sharded_mppi through K1 (4 scenarios x 64 samples, H =
      20, 2 iterations): bitwise mppi.receding_horizon on the same noise;
  45. parallel.qp_shard at qp = 1 on the contact problems of a K2 step (two
      ANYmal worlds 20 steps into a PD hold, solved in f64): the Signorini
      and cone conditions of the JAX package's tests/test_qp_shard.py;
  46. examples.atlas_batch.run(scaling=True): one row, efficiency 1.0, and
      Atlas's K1 launched once per step of the example and of the row's
      warm-up and timed repeats;
  47. utils.checkpoint of a B = 16384 card State, restored bitwise;
  48. utils.profiling.trace of one K1 launch (the trace must name the
      kernel and the `k1.step` and `k1.enqueue` spans), and tune_sweeps on
      the ANYmal scene.

Both launch counters are set to 0 just before phases 3, 4, 8, 9, 14, 15, 20,
24, 30-35, 37, 38-41 and 42-44, 46 and read just after: each path must launch its own kernel
once per physics step and the other kernel never (the examples: K1 once per
physics step they take, K2 never; the cartpole neither). Any failure exits non-zero. The last line of
standard output is one JSON object naming the device; the line before it
holds the kernels' numbers, and the line before that the card's name and
power limit.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12      # float32 outside the tensor cores


def fail(msg):
  print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
  sys.exit(1)


def note(msg):
  print(msg, flush=True)


def anymal_scene(torch, dt=0.0025, kp=100.0, kd=2.0, device=None, terrain=False):
  """ANYmal on the ground plane, or (terrain=True) on a flat 12 x 6 m
  heightmap of 48 x 24 samples whose heights each step may replace."""
  from raisimlib_torch.models import anymal
  from raisimlib_torch.models.urdf import load_urdf
  from raisimlib_torch.utils import terrain as tr
  from raisimlib_torch.world import World

  bodies, geoms, _ = load_urdf(anymal.anymal_urdf())
  world = World(dt=dt, dtype=torch.float32, device=device)   # None: the card
  world.add_articulated_system(bodies, name="anymal", geoms=geoms)
  if terrain:
    world.add_heightmap(tr.flat(0.0, size=(12.0, 6.0), samples=(48, 24), device=device))
  else:
    world.add_ground()
  return world.compile().set_pd_gains(kp, kd)


def standing_states(torch, scene, B, seed, noise=0.02):
  """B states at the nominal stance + `noise` Gaussian on q (renormalised)."""
  from raisimlib_torch.models import anymal

  q0 = anymal.standing_q()
  rng = np.random.RandomState(seed)
  q = np.tile(q0[None], (B, 1)) + noise * rng.randn(B, q0.size)
  q[:, 3:7] /= np.linalg.norm(q[:, 3:7], axis=1, keepdims=True)
  pd = np.zeros((B, scene.model.nv))
  pd[:, 6:] = q0[7:]
  f32 = dict(dtype=torch.float32, device=scene.device)
  return scene.init_state(q=torch.tensor(q, **f32)), torch.tensor(pd, **f32), q0


def random_problem(torch, B, nc, seed, kinds=(), nv=None):
  g = torch.Generator(device="cuda").manual_seed(seed)
  f32 = dict(dtype=torch.float32, device="cuda", generator=g)
  nv = 3 * nc + 4 if nv is None else nv
  Jr = torch.randn(B, nc, 3, nv, **f32)
  A = torch.randn(B, nv, nv, **f32)
  M = A @ A.transpose(-1, -2) + 3.0 * torch.eye(nv, device="cuda")
  Wt = (Jr.reshape(B, 3 * nc, nv) @ torch.linalg.inv(M)).reshape(Jr.shape)
  vf = torch.randn(B, nv, **f32)
  bias = torch.zeros(B, nc, 3, device="cuda")
  mu = 0.3 + 0.9 * torch.rand(B, nc, **f32)
  active = (torch.rand(B, nc, **f32) > 0.3).float()
  for i, k in enumerate(kinds):
    if k == "lin":
      Jr[:, i, :2] = 0.0
      Wt[:, i, :2] = 0.0
      mu[:, i] = 0.0
    elif k == "bilateral":
      mu[:, i] = 1e7
  return [Jr, Wt, vf, bias, mu, active]


def check_kernel(torch, args, kinds, label, kernel_out=None, plain_out=None):
  """K2 vs `_mf_plain` on the same inputs, with the two-tier check of
  tests/test_pallas_contact.py: >= 99% of lam entries within 1e-4 of the
  impulse scale, all within 3e-2, and the kernel's objective never worse by
  more than 2e-3 relative; and u within 3e-2 of its scale (max |u| + 1).
  `kernel_out` and `plain_out`, where given, are the two (u, lam) already
  computed on args. Returns the max abs error over lam and u, and the
  kernel's outputs."""
  from raisimlib_torch.ops import contact as ct
  from raisimlib_torch.ops import gpu_contact as gc

  cfg = ct.SolverConfig(row_kinds=kinds)
  uk, lk = gc.solve_dynamics_batch(*args, cfg) if kernel_out is None else kernel_out
  up, lp = gc._mf_plain(*args, cfg) if plain_out is None else plain_out
  torch.cuda.synchronize()
  if not (torch.isfinite(lk).all() and torch.isfinite(uk).all()):
    fail(f"{label}: kernel output not finite")
  scale = float(lp.abs().max()) + 1.0
  rel = (lk - lp).abs() / scale
  frac = float((rel < 1e-4).float().mean())
  relmax = float(rel.max())
  Jr, Wt, vf, bias = args[:4]
  B, nc, _, nv = Jr.shape
  Jf, Wf = Jr.reshape(B, 3 * nc, nv), Wt.reshape(B, 3 * nc, nv)
  G = Jf @ Wf.transpose(-1, -2)
  c = (Jf @ vf.unsqueeze(-1)).squeeze(-1) - bias.reshape(B, -1)

  def energy(lam):
    lf = lam.reshape(B, -1, 1)
    return (0.5 * (lf.transpose(-1, -2) @ G @ lf).reshape(B)
            + (c.unsqueeze(1) @ lf).reshape(B))

  Ek, Ep = energy(lk), energy(lp)
  worse = float(((Ek - Ep) / (Ep.abs() + 1.0)).max())
  u_err = float((uk - up).abs().max())
  u_rel = u_err / (float(up.abs().max()) + 1.0)
  err = max(float((lk - lp).abs().max()), u_err)
  note(f"  {label}: B={B} nc={nc} within 1e-4: {frac:.4f}, max rel {relmax:.2e}, "
       f"max abs err {err:.2e}, u max rel {u_rel:.2e}, objective worse by at most {worse:.2e}")
  if frac < 0.99 or relmax >= 3e-2 or worse > 2e-3 or u_rel >= 3e-2:
    fail(f"{label}: kernel disagrees with its plain twin")
  return err, (uk, lk)


def check_k2_tails(torch, args, kinds, label, against_twin=True):
  """K2 on the first TAIL_BATCHES worlds of args: each tail within
  check_kernel's tiers of the twin (unless not `against_twin`: where the
  whole batch was just held to it) and bitwise equal to the same worlds of
  the whole batch; and the whole batch launched twice, bitwise equal (the
  lanes of a world share its memory: a race would show as a difference).
  Returns the max abs error against the twin (0 without it)."""
  from raisimlib_torch.ops import contact as ct
  from raisimlib_torch.ops import gpu_contact as gc

  cfg = ct.SolverConfig(row_kinds=kinds)
  full = gc.solve_dynamics_batch(*args, cfg)
  again = gc.solve_dynamics_batch(*args, cfg)
  torch.cuda.synchronize()
  if not all(torch.equal(a, b) for a, b in zip(full, again)):
    fail(f"{label}: two K2 launches on the same inputs differ")
  err = 0.0
  for b in TAIL_BATCHES:
    tail = [x[:b] for x in args]
    if against_twin:
      e, out = check_kernel(torch, tail, kinds, f"{label}, B={b}")
    else:
      e, out = 0.0, gc.solve_dynamics_batch(*tail, cfg)
    if not all(torch.equal(x, y[:b]) for x, y in zip(out, full)):
      fail(f"{label}, B={b}: the tail's worlds differ from the same worlds of "
           f"B={args[0].shape[0]}")
    err = max(err, e)
  note(f"  {label}: B={args[0].shape[0]} twice, bitwise equal; B={TAIL_BATCHES} bitwise equal "
       f"to their worlds in it")
  return err


# K1 vs its twin, per world (max over the world's q or u entries). Tight tier:
# the float32 noise of the step itself (the twin in f32 against f64 differs by
# up to 7e-5 on u on these states) plus FMA contraction, which the kernel has
# and the twin does not, each a rounding that the 12 Gauss-Seidel sweeps and a
# near-tie of the cone's angular grid can amplify: 99% of worlds within 2e-5
# on q and 2e-4 on u. Ceiling, for every world: the kernel-vs-pure bounds of
# tests/test_torch_step.py (5e-4 on q, 5e-3 on u).
K1_TIGHT = (2e-5, 2e-4)
K1_CEILING = (5e-4, 5e-3)


def check_fused(torch, step, s, tau, pd, label, hts=None, ceiling_share=0.0):
  """K1 (through its wrapper) against `_fused_plain` on the same inputs
  (and per-world terrain heights `hts` on a heightmap scene); returns (max
  abs err, K1's state). At most `ceiling_share` of the worlds (rounded
  down; none by default) may pass the ceiling (see ATLAS_BRANCH_SHARE)."""
  from raisimlib_torch.ops import gpu_step as gs

  sk = step(s, tau, pd, field_heights=hts)
  qp, up = gs._fused_plain(step.sd, s.q, s.u, tau, pd, step.heights(s.q, hts))
  torch.cuda.synchronize()
  if not (torch.isfinite(sk.q).all() and torch.isfinite(sk.u).all()):
    fail(f"{label}: K1 output not finite")
  dq = (sk.q - qp).abs().amax(1)
  du = (sk.u - up).abs().amax(1)
  frac = float(((dq <= K1_TIGHT[0]) & (du <= K1_TIGHT[1])).float().mean())
  dq_max, du_max = float(dq.max()), float(du.max())
  over = (dq > K1_CEILING[0]) | (du > K1_CEILING[1])
  n_over, allowed = int(over.sum()), int(ceiling_share * s.q.shape[0])
  note(f"  {label}: B={s.q.shape[0]} worlds within ({K1_TIGHT[0]:.0e} q, "
       f"{K1_TIGHT[1]:.0e} u): {frac:.4f}; max |dq| {dq_max:.2e}, max |du| {du_max:.2e}"
       + (f"; {n_over} world(s) past the ceiling, {allowed} allowed "
          f"{torch.nonzero(over).flatten().tolist()[:8]}" if ceiling_share else ""))
  if frac < 0.99 or n_over > allowed:
    fail(f"{label}: K1 disagrees with its plain twin")
  return max(dq_max, du_max), sk


def check_against_k2(torch, scene, step, s, tau, pd, label, hts=None, share=0.0):
  """K1 against the K2 path (Scene.step_batch) on the same inputs, at the
  kernel-vs-pure bounds of tests/test_torch_step.py (allclose: 5e-4 + 1e-4
  |ref| on q, 5e-3 + 1e-3 |ref| on u), in every world but at most `share`
  of them (rounded down; none by default)."""
  s1 = step(s, tau, pd, field_heights=hts)
  s2 = scene.step_batch(s, tau, pd, field_heights=hts)
  torch.cuda.synchronize()
  over = ((((s1.q - s2.q).abs() - 5e-4 - 1e-4 * s2.q.abs()).amax(1) > 0.0)
          | (((s1.u - s2.u).abs() - 5e-3 - 1e-3 * s2.u.abs()).amax(1) > 0.0))
  n_over, allowed = int(over.sum()), int(share * s.q.shape[0])
  note(f"  {label}: max |dq| {float((s1.q - s2.q).abs().max()):.2e}, "
       f"max |du| {float((s1.u - s2.u).abs().max()):.2e}"
       + (f"; {n_over} world(s) past the bounds, {allowed} allowed "
          f"{torch.nonzero(over).flatten().tolist()[:8]}" if share else ""))
  if n_over > allowed:
    fail(f"{label}: K1 and the K2 path part beyond the kernel-vs-pure bounds")


# batches whose last warp holds fewer worlds than it has room for (a warp
# holds 32 // gpu_step.LANES worlds; a world past B runs on a clamped index and
# stores nothing); on an H100 they take the wide build (gpu_step.lanes_for)
TAIL_BATCHES = (1, 3, 383)


def check_tails(torch, step, s, tau, pd, label, hts=None, ceiling_share=0.0):
  """K1 on the first TAIL_BATCHES worlds of s: each tail within
  check_fused's tiers of the twin and bitwise equal to the same worlds of
  the batch s, both as launched (the build the width rule takes for the
  tail: the wide one on an H100, where s takes the narrow one) and through
  the narrow build (gpu_step.LANES lanes, its last warp partly empty); and s
  launched twice, bitwise equal (the lanes of a world share its memory: a
  race would show as a difference). Returns the max abs error against the
  twin."""
  from raisimlib_torch.ops import gpu_step as gs
  from raisimlib_torch.ops.integrator import State

  full = step(s, tau, pd, field_heights=hts)
  again = step(s, tau, pd, field_heights=hts)
  torch.cuda.synchronize()
  if not (torch.equal(full.q, again.q) and torch.equal(full.u, again.u)):
    fail(f"{label}: two launches on the same inputs differ")
  B = s.q.shape[0]
  err, widths = 0.0, []
  for b in TAIL_BATCHES:
    cut = lambda x: None if x is None else x[:b]    # noqa: E731
    sb = State(q=s.q[:b], u=s.u[:b], t=s.t[:b])
    e, sk = check_fused(torch, step, sb, tau[:b], cut(pd), f"{label}, B={b}", cut(hts),
                        ceiling_share)
    lanes = step.kernel.lanes(b, s.q.device)
    narrow = step.kernel.launch_build(gs.LANES, sb.q, sb.u, tau[:b], cut(pd),
                                      step.heights(sb.q, cut(hts)))
    torch.cuda.synchronize()
    for got, how in (((sk.q, sk.u), f"as launched ({lanes} lanes)"),
                     (narrow, f"at {gs.LANES} lanes")):
      if not (torch.equal(got[0], full.q[:b]) and torch.equal(got[1], full.u[:b])):
        fail(f"{label}, B={b}: the tail's worlds {how} differ from the same worlds of B={B}")
    widths.append(lanes)
    err = max(err, e)
  note(f"  {label}: B={B} ({step.kernel.lanes(B, s.q.device)} lanes) twice, bitwise equal; "
       f"B={TAIL_BATCHES} bitwise equal to their worlds in it, as launched ({widths} lanes) "
       f"and at {gs.LANES} lanes")
  return err


def source_figures(gs, _build, kern):
  """What ptxas said about a fused-step source (registers, stack, spills,
  static shared memory) and the block's shared memory, lanes and minimum
  blocks per SM; and the same of its wide build (gpu_step.WIDE lanes)."""
  wide = dict(_build.ptxas_figures(kern.names[gs.WIDE]), lanes=gs.WIDE,
              min_blocks=gs.min_blocks(kern.sd, gs.WIDE))
  return dict(_build.ptxas_figures(kern.name), smem_block_bytes=kern.smem_bytes,
              lanes=gs.LANES, min_blocks=gs.min_blocks(kern.sd), wide=wide)


K1B_KINDS = ("ss", "sb", "sc")


def check_k1b(torch, scene, step, s, tau, label, touching=True):
  """K1b against its twin (check_fused) and against the K2 path, after
  reporting the share of worlds in which each sphere pair touches (the K2
  path's narrow phase); with `touching`, each must touch in some world.
  Returns K1b's max abs error against the twin."""
  from raisimlib_torch.ops import collision as coll
  from raisimlib_torch.ops import dynamics

  idx = [i for i, x in enumerate(step.sd.slots) if x.kind in K1B_KINDS]
  act = coll.collide(scene.geoms, scene.pairs, dynamics.fk(scene.model, s.q)).active[:, idx]
  share = act.float().mean(0).tolist()
  note(f"  {label}: share of worlds touching per sphere pair "
       f"{[round(x, 4) for x in share]}")
  if touching and min(share) == 0.0:
    fail(f"{label}: a sphere pair touches in no world")
  err = check_fused(torch, step, s, tau, None, label)[0]
  check_against_k2(torch, scene, step, s, tau, None, f"{label}, K1b vs K2 path")
  return err


def sync(torch, dev):
  if torch.device(dev).type == "cuda":
    torch.cuda.synchronize()


def time_cuda(torch, fn, reps):
  """Mean ms per call by CUDA events over `reps` calls after one warm-up."""
  fn()
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  stop = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(reps):
    fn()
  stop.record()
  torch.cuda.synchronize()
  return start.elapsed_time(stop) / reps


def reset_counts(gc, gs):
  gc.solve_dynamics_batch.launches = 0
  gs.make_step_batch_fused.launches = 0


def read_counts(gc, gs):
  return gc.solve_dynamics_batch.launches, gs.make_step_batch_fused.launches


def rollouts(torch, step, s, pd, H, gc, gs, label):
  """H synchronised steps of `step` from s: (state, seconds, (K2, K1) counts)."""
  step(s, pd)                                        # warm-up
  torch.cuda.synchronize()
  reset_counts(gc, gs)
  t0 = time.perf_counter()
  for _ in range(H):
    s = step(s, pd)
  torch.cuda.synchronize()
  t = time.perf_counter() - t0
  counts = read_counts(gc, gs)
  if not (torch.isfinite(s.q).all() and torch.isfinite(s.u).all()):
    fail(f"{label}: rollout state not finite")
  z = s.q[:, 2]
  z_lo, z_hi = float(z.min()), float(z.max())
  if z_lo < 0.35 or z_hi > 0.75:
    fail(f"{label}: base height left the band [0.35, 0.75]: [{z_lo:.3f}, {z_hi:.3f}]")
  B = s.q.shape[0]
  note(f"  rollouts/s {B / t:.1f}  ms/step {1e3 * t / H:.3f}  launches K2 {counts[0]} "
       f"K1 {counts[1]}  base z [{z_lo:.3f}, {z_hi:.3f}]")
  return s, t, counts


def run_mppi(torch, scene, q0, fused, gc, gs):
  """2 updates of 16 envs x 128 samples, H = 50, 4 substeps: (seconds,
  (K2, K1) counts, physics steps)."""
  from raisimlib_torch.mpc import mppi, state_map
  from raisimlib_torch.ops.spatial import quat_box_minus

  E, K, HM, sub, updates = 16, 128, 50, 4, 2
  note(f"  mppi_step_batch, {E} envs x {K} samples, H={HM}, {sub} substeps, "
       f"{updates} updates, fused={fused!r}")
  dyn_b, nx, nu = state_map.make_contact_dyn_batch(scene, control_dt=0.01, substeps=sub,
                                                   fused=fused)
  z0 = float(q0[2])
  q_stand = torch.tensor(q0[7:], dtype=torch.float32, device="cuda")
  ident = torch.tensor([1.0, 0.0, 0.0, 0.0], device="cuda")

  def rc(X, A, t):
    return (40.0 * (X[:, 2] - z0) ** 2
            + 10.0 * torch.sum(quat_box_minus(X[:, 3:7], ident) ** 2, 1)
            + 0.5 * torch.sum(X[:, 19:25] ** 2, 1)
            + torch.sum((A - q_stand) ** 2, 1)) * 0.01

  def fc(X):
    return 200.0 * (X[:, 2] - z0) ** 2 + 5.0 * torch.sum(X[:, 19:25] ** 2, 1)

  rng = np.random.RandomState(3)
  x0 = np.concatenate([q0, np.zeros(18)])
  x0s = np.tile(x0[None], (E, 1))
  x0s[:, 19 + 4] += 0.1 * rng.randn(E)
  x0s = torch.tensor(x0s, dtype=torch.float32, device="cuda")
  Us = q_stand.expand(E, HM, nu).clone()
  cfg_m = mppi.MPPIConfig(n_samples=K, sigma=0.1, temperature=0.3)
  gen = torch.Generator(device="cuda").manual_seed(4)
  with torch.inference_mode():
    torch.cuda.synchronize()
    reset_counts(gc, gs)
    t0 = time.perf_counter()
    for _ in range(updates):
      sol = mppi.mppi_step_batch(dyn_b, rc, fc, x0s, Us, gen, cfg_m)
      Us = sol.U
    torch.cuda.synchronize()
    t = time.perf_counter() - t0
    counts = read_counts(gc, gs)
  if not (torch.isfinite(sol.cost).all() and torch.isfinite(Us).all()):
    fail("MPPI costs or plans not finite")
  steps = updates * HM * sub
  note(f"  MPPI solves/s {E * updates / t:.2f}  physics steps/s "
       f"{E * K * steps / t:.0f}  launches K2 {counts[0]} K1 {counts[1]}  "
       f"cost of plan [{float(sol.cost.min()):.4f}, {float(sol.cost.max()):.4f}]")
  return t, counts, steps


def golden_replay(torch, step, label):
  """Replay tests/goldens/anymal_balance.npz in f32 through `step(state, pd)`
  and hold it to the batched path's gate."""
  from raisimlib_torch.utils import parity

  here = os.path.dirname(os.path.abspath(__file__))
  g = np.load(os.path.join(here, "tests", "goldens", "anymal_balance.npz"))
  gscene = anymal_scene(torch, kp=float(g["kp"]), kd=float(g["kd"]))
  f32 = dict(dtype=torch.float32, device="cuda")
  gs_ = gscene.init_state(q=torch.tensor(g["q0"][None], **f32),
                          u=torch.tensor(g["u0"][None], **f32))
  stepfn = step(gscene)
  qs, us = [], []
  with torch.inference_mode():
    for tgt in g["pd_targets"]:
      gs_ = stepfn(gs_, torch.tensor(tgt[None], **f32))
      qs.append(gs_.q[0].cpu().numpy())
      us.append(gs_.u[0].cpu().numpy())
  dtau, dq = parity.golden_deviation(np.stack(qs), np.stack(us), g)
  k = parity.BATCH_TIGHT_STEPS
  note(f"  {label}: first {k} steps: max|dtau| {dtau[:k].max():.3e} N m, max|dq| "
       f"{dq[:k].max():.3e}; all {len(dtau)}: max|dtau| {dtau.max():.3e} N m, "
       f"max|dq| {dq.max():.3e}")
  failures = parity.batch_gate_failures(np.stack(qs), np.stack(us), g)
  if failures:
    fail(f"{label} golden gate: " + "; ".join(failures))


def make_terrains(torch, n, seed=11, device=None):
  """(n, 48, 24) fractal heights (12 x 6 m, z_scale 0.06) on `device` (None:
  the card), the lattices drawn from one torch.Generator seeded with `seed`."""
  from raisimlib_torch.utils import terrain

  props = terrain.TerrainProperties(z_scale=0.06, x_size=12.0, y_size=6.0,
                                    x_samples=48, y_samples=24)
  gen = torch.Generator().manual_seed(seed)
  return torch.stack([terrain.generate(props, gen, device=device).heights for _ in range(n)])


def terrain_states(torch, scene, hts, seed, noise=0.02):
  """standing_states on per-world terrain heights hts (B, nx, ny): the base
  raised by the terrain's height under it."""
  from raisimlib_torch.ops import heightmap as hm

  s, pd, q0 = standing_states(torch, scene, hts.shape[0], seed, noise)
  z, _, _ = hm.surface_at(scene.field.replace(heights=hts), s.q[:, :2])
  s.q[:, 2] += z
  return s, pd, q0


def gait_reference(torch, n, control_dt, q_stand, freq=1.5, swing=0.22):
  """(n, 12) PD targets of examples/anymal_trot_heightmap.py: the stance plus
  trot flexion on the swing pair (LF+RH at phase 0, RF+LH at pi)."""
  dev = q_stand.device
  t = torch.arange(n, dtype=torch.float32, device=dev) * control_dt
  phase = 2.0 * np.pi * freq * t
  offsets = torch.tensor([0.0, np.pi, np.pi, 0.0], device=dev)
  mirror = torch.tensor([1.0, 1.0, -1.0, -1.0], device=dev)        # hind legs mirrored
  sw = torch.clamp(torch.sin(phase[:, None] + offsets[None, :]), min=0.0)
  tgt = q_stand[None].repeat(n, 1).reshape(n, 4, 3)
  tgt[:, :, 1] += swing * sw * mirror[None, :]                      # HFE flex
  tgt[:, :, 2] += -1.6 * swing * sw * mirror[None, :]               # KFE fold
  return tgt.reshape(n, 12)


def run_trot(torch, ticks, gc, gs, E=4, K=96, HM=16, device=None):
  """examples/anymal_trot_heightmap.py's closed loop on the scenario's widths
  (scenarios/anymal_trot_heightmap.yaml): ANYmal with kp = 120, kd = 3 on
  E = 4 terrains, MPPI with K = 96 samples, HM = 16 control steps of 0.02 s,
  8 physics substeps, sigma 0.1, temperature 0.25, toward 0.35 m/s. Returns
  (seconds, (K2, K1) counts, final states, MPC solves/s)."""
  from raisimlib_torch.models import anymal
  from raisimlib_torch.mpc import mppi, state_map
  from raisimlib_torch.ops import heightmap as hm
  from raisimlib_torch.ops.spatial import quat_box_minus

  sub, control_dt, v_target = 8, 0.02, 0.35
  scene = anymal_scene(torch, kp=120.0, kd=3.0, device=device, terrain=True)
  dev = scene.device
  dyn_b, nx, nu = state_map.make_contact_dyn_batch(scene, control_dt, sub, fused="require")
  heights = make_terrains(torch, E, device=dev)
  field0 = scene.field
  q0 = torch.tensor(anymal.standing_q(), dtype=torch.float32, device=dev)
  z0 = float(q0[2])
  ident = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev)
  gait = gait_reference(torch, ticks + HM, control_dt, q0[7:])

  def rc(X, A, t, h):
    q, v = X[:, :19], X[:, 19:]
    z, _, _ = hm.surface_at(field0.replace(heights=h), q[:, :2])
    return (9.0 * (v[:, 3] - v_target) ** 2                        # forward speed
            + 30.0 * (q[:, 2] - z - z0) ** 2                        # height over terrain
            + 8.0 * torch.sum(quat_box_minus(q[:, 3:7], ident) ** 2, 1)
            + 0.3 * (v[:, 4] ** 2 + v[:, 5] ** 2)                   # lateral, vertical
            + 0.02 * torch.sum(v[:, 6:] ** 2, 1)) * control_dt

  def fc(X, h):
    q = X[:, :19]
    z, _, _ = hm.surface_at(field0.replace(heights=h), q[:, :2])
    return 100.0 * (q[:, 2] - z - z0) ** 2 + 30.0 * torch.sum(
        quat_box_minus(q[:, 3:7], ident) ** 2, 1)

  z_start, _, _ = hm.surface_at(field0.replace(heights=heights), q0[None, :2].expand(E, 2))
  xs = torch.cat([q0[None].repeat(E, 1), torch.zeros((E, 18), device=dev)], 1)
  xs[:, 2] += z_start
  dUs = torch.zeros((E, HM, nu), device=dev)
  cfg = mppi.MPPIConfig(n_samples=K, sigma=0.1, temperature=0.25)
  gen = torch.Generator(device=dev).manual_seed(7)
  note(f"  {E} terrains x {K} samples, H={HM}, {sub} substeps, {ticks} ticks of "
       f"{control_dt} s, fused='require'")
  with torch.inference_mode():
    sync(torch, dev)
    reset_counts(gc, gs)
    t0 = time.perf_counter()
    for m in range(ticks):
      base = gait[m:m + HM]
      sol = mppi.mppi_step_batch(dyn_b, rc, fc, xs, base[None] + dUs, gen, cfg,
                                 env_ctx=heights)
      xs = dyn_b(xs, sol.U[:, 0], 0, heights)
      dUs = torch.cat([sol.U[:, 1:] - base[None, 1:], sol.U[:, -1:] - base[None, -1:]], 1)
    sync(torch, dev)
    t = time.perf_counter() - t0
    counts = read_counts(gc, gs)
  return t, counts, xs, E * ticks / t


def trot_golden(torch, step_for, label, device=None):
  """Replay tests/goldens/anymal_trot_heightmap.npz in f32 through
  `step_for(scene)(state, pd)` and hold it to the trot gate."""
  from raisimlib_torch.utils import parity

  here = os.path.dirname(os.path.abspath(__file__))
  g = np.load(os.path.join(here, "tests", "goldens", "anymal_trot_heightmap.npz"))
  scene = anymal_scene(torch, dt=float(g["dt"]), kp=float(g["kp"]), kd=float(g["kd"]),
                       device=device, terrain=True)
  f32 = dict(dtype=torch.float32, device=scene.device)
  scene = scene.replace(field=scene.field.replace(heights=torch.tensor(g["heights"], **f32)))
  stepfn = step_for(scene)
  s = scene.init_state(q=torch.tensor(g["q0"][None], **f32), u=torch.tensor(g["u0"][None], **f32))
  qs, us = [], []
  with torch.inference_mode():
    for tgt in g["pd_targets"]:
      s = stepfn(s, torch.tensor(tgt[None], **f32))
      qs.append(s.q[0].cpu().numpy())
      us.append(s.u[0].cpu().numpy())
  qs, us = np.stack(qs), np.stack(us)
  d = parity.trot_deviation(qs, us, g)
  worst = int(d.max(1).argmax())
  note(f"  {label}: {len(qs)} steps: {100 * float((d <= parity.TORQUE_GATE).mean()):.2f}% of "
       f"applied-torque entries within {parity.TORQUE_GATE} N m, max|dtau| {d.max():.3e} N m "
       f"(step {worst}), max|dq| {np.abs(qs - g['q']).max():.3e}")
  failures = parity.trot_gate_failures(qs, us, g)
  if failures:
    fail(f"{label} trot gate: " + "; ".join(failures))
  return float(d.max())


def _stack_config():
  """BASELINE config 2, the sphere-box stack, from the port's scenario file
  (raisimlib_torch/scenarios/sphere_box_stack.json, a copy of the JAX
  package's YAML; a CPU test holds the two equal): the world's dt and
  gravity, the box's and the sphere's add_* arguments, the run's length,
  kick and gates. None where the file is not beside this script."""
  path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "raisimlib_torch",
                      "scenarios", "sphere_box_stack.json")
  if not os.path.exists(path):
    return None
  with open(path) as f:
    cfg = json.load(f)
  w, run = cfg["world"], cfg["run"]
  objs = {o["type"]: o for o in w["objects"]}
  return {
      "dt": w["dt"],
      "gravity": tuple(w["gravity"]),
      "box": {k: objs["box"][k] for k in ("half_extents", "mass", "pos")},
      "sphere": {k: objs["sphere"][k] for k in ("radius", "mass", "pos")},
      "sim_seconds": run["sim_seconds"],
      "kick_m_s": run["kick_m_s"],             # on the box's x dof (u[3])
      "gates": run["gates"],
  }


STACK = _stack_config()


# Phase 20's noise per world: 1e-3 m on both bodies' positions, 1e-2 m/s on
# the box's linear velocity (u = [angular, linear] per body). The
# orientations and the sphere's velocity stay exact: a sphere on a flat face
# keeps any rolling speed it is given (there is no rolling resistance), and
# the example's speed gate (0.05 on every |u| entry) takes its spin too. A
# box tilted by 1e-3 at the start lands on an edge and rocks, which hands the
# sphere ~1 cm/s (0.1 rad/s of spin) and fails that gate by physics, not by
# the kernel; phase 20 reports how many worlds phase 18's noise on every
# entry fails.
STACK_DQ = np.r_[[1e-3] * 3, [0.0] * 4, [1e-3] * 3, [0.0] * 4]
STACK_DU = np.r_[[0.0] * 3, [1e-2] * 3, [0.0] * 6]


def stack_scene(torch, device=None, dtype=None):
  """The stack of examples/sphere_box_stack.py: the ground, a box, a sphere
  (the YAML's order). Its bodies carry no PD gains."""
  from raisimlib_torch.world import World

  world = World(dt=STACK["dt"], gravity=STACK["gravity"], dtype=dtype or torch.float32,
                device=device)
  world.add_ground()
  world.add_box(**STACK["box"])
  world.add_sphere(**STACK["sphere"])
  return world.compile()


def spheres_capsule_scene(torch, device=None, dtype=None):
  """Two stacked spheres and a capsule on the ground (the scene of the JAX
  package's tests/test_pallas_step.py TestRuntimeFramePairs): "ss" and "sc"
  slots."""
  from raisimlib_torch.world import World

  world = World(dt=0.002, dtype=dtype or torch.float32, device=device)
  world.add_ground()
  world.add_sphere(0.1, 1.0, pos=(0.0, 0.0, 0.11), name="a")
  world.add_sphere(0.1, 1.0, pos=(0.12, 0.0, 0.28), name="b")
  world.add_capsule(0.06, 0.15, 0.5, pos=(1.0, 0.0, 0.07), name="c")
  return world.compile(joint_limits=False)


def static_box_scene(torch, device=None, dtype=None):
  """A sphere resting on a static box (turned 0.3 rad about z) on the
  ground: an "sb" slot whose box is world geometry (body -1)."""
  from raisimlib_torch.world import World

  c, s = np.cos(0.3), np.sin(0.3)
  world = World(dt=0.002, dtype=dtype or torch.float32, device=device)
  world.add_ground()
  world.add_box((0.3, 0.2, 0.1), 0.0, pos=(0.0, 0.0, 0.1), static=True,
                rot=[[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
  world.add_sphere(0.1, 1.0, pos=(0.05, 0.02, 0.3))
  return world.compile(joint_limits=False)


# states in which every sphere pair of a scene touches: spheres a and b side
# by side on the capsule (laid along y), touching each other; the sphere on
# the static box
CONTACT_Q = {
    "spheres_capsule": [1.0, -0.08, 0.217, 1, 0, 0, 0, 1.0, 0.115, 0.217, 1, 0, 0, 0,
                        1.0, 0.0, 0.0595, np.cos(np.pi / 4), np.cos(np.pi / 4), 0, 0],
    "static_box": [0.05, 0.02, 0.299, 1, 0, 0, 0],
}


def loose_states(torch, scene, B, seed, dq=1e-3, du=1e-2, kick=None, q0=None):
  """B states at q0 (default: the scene's initial q) with Gaussian noise dq
  on q (quaternions renormalised) and du on u, each a scale or one per
  entry, plus `kick` (dof, m/s)."""
  from raisimlib_torch.models.model import JointType

  m = scene.model
  rng = np.random.RandomState(seed)
  if q0 is None:
    q0 = m.q_init.cpu().numpy()
  q = np.tile(np.asarray(q0, np.float64)[None], (B, 1))
  q += dq * rng.randn(B, m.nq)
  for b in range(m.nb):
    if JointType(m.joint_types[b]) == JointType.FREE:
      qa = m.q_adr[b] + 3
      q[:, qa:qa + 4] /= np.linalg.norm(q[:, qa:qa + 4], axis=1, keepdims=True)
  u = du * rng.randn(B, m.nv)
  if kick is not None:
    u[:, kick[0]] += kick[1]
  f32 = dict(dtype=torch.float32, device=scene.device)
  return scene.init_state(q=torch.tensor(q, **f32), u=torch.tensor(u, **f32))


# phases 22-26: one loose cylinder, cone or convex rock per world on the
# terrain of phase 12 (RaiSim's addCylinder, addCone and addMesh on
# addHeightMap). The cylinder and the cone are those of the JAX package's
# tests/test_pallas_step.py (TestHeightmapCylCone); the rock has exactly
# MAX_MESH_VERTS = 32 hull vertices, the widest mesh the kernel probes. Each
# body goes in a world of its own: two of them would pair through the
# support-function kernel, which K1 does not take.
DEBRIS = {"cylinder": dict(radius=0.1, half_length=0.15, mass=1.0),
          "cone": dict(radius=0.12, height=0.2, mass=1.0),
          "mesh": dict(mass=2.0)}
DEBRIS_NAMES = ("cylinder", "cone", "mesh")
SINK_STEPS = 50                 # phase 25: a probe 5 mm deep through all of these sinks
ROCK_SEMI_AXES = (0.15, 0.10, 0.08)
# a cube (half extent 0.1 m, 1 kg) as a mesh: yawed on flat ground, its 4
# bottom vertices are equally deep, the tie case of the mesh selection
CUBE = np.array([[sx, sy, sz] for sx in (-0.1, 0.1) for sy in (-0.1, 0.1)
                 for sz in (-0.1, 0.1)])


def rock_vertices():
  """The rock's 32 hull vertices: the Fibonacci directions of
  collision.hull_support_sample scaled to ROCK_SEMI_AXES, all on an
  ellipsoid, so that each is a vertex of the hull."""
  k = 32
  idx = np.arange(k)
  phi = np.pi * (3.0 - np.sqrt(5.0)) * idx
  z = 1.0 - 2.0 * (idx + 0.5) / k
  r = np.sqrt(np.maximum(1.0 - z * z, 0.0))
  return np.stack([r * np.cos(phi), r * np.sin(phi), z], 1) * np.asarray(ROCK_SEMI_AXES)


def add_debris(world, name):
  """Add debris body `name` ("cylinder", "cone", "mesh" or "cube") to
  `world`, a World of the port (or of the JAX package: the calls are the
  same)."""
  if name == "cylinder":
    world.add_cylinder(**DEBRIS["cylinder"])
  elif name == "cone":
    world.add_cone(**DEBRIS["cone"])
  elif name == "mesh":
    world.add_mesh(rock_vertices(), **DEBRIS["mesh"])
  else:
    world.add_mesh(CUBE, 1.0, name="cube")


def debris_scene(torch, name, device=None, dtype=None):
  """A flat 12 x 6 m heightmap of 48 x 24 samples (its heights replaced per
  world) and one debris body, dt = 2 ms, no PD gains."""
  from raisimlib_torch.utils import terrain as tr
  from raisimlib_torch.world import World

  world = World(dt=0.002, dtype=dtype or torch.float32, device=device)
  world.add_heightmap(tr.flat(0.0, size=(12.0, 6.0), samples=(48, 24), device=device))
  add_debris(world, name)
  return world.compile(joint_limits=False)


def debris_states(torch, scene, hts, seed):
  """Drop states over per-world heights hts (B, 48, 24): x ~ U(-4.5, 4.5) m
  and y ~ U(-1.5, 1.5) m (1.5 m of terrain on every side), z the surface
  below plus U(0.25, 0.45) m, a uniformly random orientation, linear
  velocity N(0, 0.3) m/s and angular velocity N(0, 1) rad/s per axis."""
  from raisimlib_torch.ops import heightmap as hm

  B = hts.shape[0]
  rng = np.random.RandomState(seed)
  q = np.zeros((B, 7))
  q[:, 0] = rng.uniform(-4.5, 4.5, B)
  q[:, 1] = rng.uniform(-1.5, 1.5, B)
  lift = rng.uniform(0.25, 0.45, B)
  quat = rng.randn(B, 4)
  q[:, 3:] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
  u = np.concatenate([rng.randn(B, 3), 0.3 * rng.randn(B, 3)], 1)   # angular, linear
  f32 = dict(dtype=torch.float32, device=scene.device)
  q = torch.tensor(q, **f32)
  z, _, _ = hm.surface_at(scene.field.replace(heights=hts), q[:, :2])
  q[:, 2] = z + torch.tensor(lift, **f32)
  return scene.init_state(q=q, u=torch.tensor(u, **f32))


def upright_states(torch, scene, name, B, seed):
  """B bodies at rest on a flat field (heights 0), turned about z only so
  that the axis is exactly vertical, 1 mm into it: a cylinder on its cap, a
  cone on its base, the cube on a face (its 4 bottom vertices equally
  deep)."""
  rng = np.random.RandomState(seed)
  yaw = rng.uniform(-np.pi, np.pi, B)
  q = np.zeros((B, 7))
  q[:, :2] = rng.uniform(-3.0, 3.0, (B, 2))
  q[:, 2] = {"cylinder": DEBRIS["cylinder"]["half_length"],
             "cone": 0.25 * DEBRIS["cone"]["height"], "cube": 0.1}[name] - 1e-3
  q[:, 3], q[:, 6] = np.cos(yaw / 2), np.sin(yaw / 2)
  f32 = dict(dtype=torch.float32, device=scene.device)
  return scene.init_state(q=torch.tensor(q, **f32), u=torch.zeros((B, 6), **f32))


def debris_contacts(torch, scene, s, hts):
  """The port's pure narrow phase (collision.collide) on states s: per
  world, the deepest active penetration and whether any slot is active."""
  from raisimlib_torch.ops import collision as coll
  from raisimlib_torch.ops import dynamics

  c = coll.collide(scene.geoms, scene.pairs, dynamics.fk(scene.model, s.q),
                   scene.field.replace(heights=hts))
  return (c.depth * c.active).amax(1), c.active.amax(1) > 0


def near_vertical(torch, q, tol=1e-5):
  """How many worlds hold the body's axis within `tol` of vertical, where
  the downhill frame switches branch at 1e-6 (float32 rounding, and FMA
  contraction on the card, can take either branch there)."""
  from raisimlib_torch.ops import spatial

  a = spatial.quat_to_mat(q[:, 3:7])[:, :, 2]
  return int(((a[:, 2:] * a[:, :2]).norm(dim=1).hypot(1.0 - a[:, 2] * a[:, 2]) < tol).sum())


def settle_gates(torch, scene, step, s, hts, n):
  """Phase 25 for one debris scene: n steps of `step(s) -> s` from s on
  per-world heights hts, then the gates. A world fails if its state is not
  finite, its COM is below the surface under it, it has left the terrain,
  or it sinks: its deepest probe stays 5 mm deep or more through each of the
  last SINK_STEPS steps. A cone rolling fast (10-14 rad/s) dips 5-10 mm at
  its rim probes for a few steps (tools/debris_drop_cpu.py shows it on the
  CPU); the worlds caught in such a dip at the last step are counted, not
  failed. Returns (gates, per-world failure mask, final state, final
  deepest-probe depth)."""
  from raisimlib_torch.ops import heightmap as hm

  for _ in range(n - SINK_STEPS):
    s = step(s)
  shallowest = torch.full_like(s.q[:, 0], float("inf"))
  deepest = torch.zeros_like(shallowest)
  for _ in range(SINK_STEPS):
    s = step(s)
    depth, touching = debris_contacts(torch, scene, s, hts)
    shallowest = torch.minimum(shallowest, depth)
    deepest = torch.maximum(deepest, depth)
  finite = torch.isfinite(s.q).all(1) & torch.isfinite(s.u).all(1)
  z, _, inside = hm.surface_at(scene.field.replace(heights=hts), s.q[:, :2])
  above = s.q[:, 2] > z
  afloat = shallowest < 5e-3
  gates = {"not_finite": int((~finite).sum()), "com_below_surface": int((~above).sum()),
           "sinking": int((~afloat).sum()), "off_terrain": int((~inside).sum()),
           "over_5mm_at_the_end": int((depth >= 5e-3).sum()),
           "max_penetration_at_the_end_m": float(depth.max()),
           f"max_penetration_last_{SINK_STEPS}_steps_m": float(deepest.max()),
           "in_contact": float(touching.float().mean()),
           "max_speed_m_s": float(s.u[:, 3:].norm(dim=1).max())}
  return gates, ~(finite & above & afloat & inside), s, depth


def stack_golden(torch, step_for, label, device=None):
  """Replay tests/goldens/sphere_box_stack.npz (400 steps, f32) through
  `step_for(scene)(state)` on a batch of one world and hold it to the stack
  gate of utils/parity.py (the JAX package's: max|dq| <= 1e-4, the resting
  heights within 2e-3). Returns max|dq|."""
  from raisimlib_torch.utils import parity

  here = os.path.dirname(os.path.abspath(__file__))
  g = np.load(os.path.join(here, "tests", "goldens", "sphere_box_stack.npz"))
  scene = stack_scene(torch, device=device)
  f32 = dict(dtype=torch.float32, device=scene.device)
  s = scene.init_state(q=torch.tensor(g["q0"][None], **f32), u=torch.tensor(g["u0"][None], **f32))
  stepfn = step_for(scene)
  qs = []
  t0 = time.perf_counter()
  with torch.inference_mode():
    for _ in range(int(g["N"])):
      s = stepfn(s)
      qs.append(s.q[0])
    qs = torch.stack(qs).cpu().numpy()
  dq = parity.stack_deviation(qs, g)
  note(f"  {label}: {len(qs)} steps in {time.perf_counter() - t0:.1f} s: max|dq| {dq.max():.3e} "
       f"(step {int(dq.argmax())}); rest box z {qs[-1, 2]:.5f}, sphere z {qs[-1, 9]:.5f}")
  failures = parity.stack_gate_failures(qs, g)
  if failures:
    fail(f"{label} stack gate: " + "; ".join(failures))
  return float(dq.max())


def reference_step(scene):
  """Scene.step, the single-world reference, as a step of a batch of one."""
  from raisimlib_torch.ops.integrator import State

  def step(s):
    s1 = scene.step(State(q=s.q[0], u=s.u[0], t=s.t[0]))
    return State(q=s1.q[None], u=s1.u[None], t=s1.t[None])
  return step


def run_stack(torch, step, s, n, gc, gs):
  """examples/sphere_box_stack.py batched: n steps of `step` from s, then
  the example's four gates for every world. Returns (seconds, (K2, K1)
  counts, final state, gate summary)."""
  g = STACK["gates"]
  step(s)                                            # warm-up (a launch, not counted)
  torch.cuda.synchronize()
  box_min = torch.full_like(s.q[:, 2], float("inf"))
  reset_counts(gc, gs)
  t0 = time.perf_counter()
  with torch.inference_mode():
    for _ in range(n):
      s = step(s)
      box_min = torch.minimum(box_min, s.q[:, 2])
  torch.cuda.synchronize()
  t = time.perf_counter() - t0
  counts = read_counts(gc, gs)
  if not (torch.isfinite(s.q).all() and torch.isfinite(s.u).all()):
    fail("stack state not finite")
  box_err = (s.q[:, 2] - g["box_rest_z"]).abs()
  sph_err = (s.q[:, 9] - g["sphere_rest_z"]).abs()
  pen = torch.clamp(g["box_rest_z"] - box_min, min=0.0)
  speed = s.u.abs().amax(1)
  summary = {"box_z_err_max": float(box_err.max()), "sphere_z_err_max": float(sph_err.max()),
             "box_penetration_max": float(pen.max()), "settled_speed_max": float(speed.max())}
  bad = ((box_err >= g["rest_tol"]) | (sph_err >= g["rest_tol"])
         | (pen >= g["max_penetration"]) | (speed >= g["settled_speed"]))
  summary["worlds_failing"] = int(bad.sum())
  return t, counts, s, summary


def run_debris(torch, gs, gc, _build, built, debris, steps, hts64, stream,
               sizes=(16384, 4096, 1037, 1024), n_settle=500):
  """Phases 22-26: a loose cylinder, cone or 32-vertex rock per world on the
  64 terrains of phase 12 (K1c's hm_cylpt, hm_conept and hm_mesh slots), at
  the batch sizes (rollouts, checks, upright checks, small timing).
  Returns the kernels line's entry for the three sources."""
  B, B_check, B_up, B_small = sizes
  H = 50
  dev = hts64.device
  src = {}

  # ---- 22. the three sources -------------------------------------------------------------
  note("phase 22: the K1c sources of the debris scenes (hm_cylpt, hm_conept, hm_mesh)")
  for name in DEBRIS_NAMES + ("cube",):
    st = steps[name]
    k = st.kernel
    hts1 = torch.zeros((1, 48, 24), device=dev)
    s1 = debris_states(torch, debris[name], hts1, seed=1)
    with torch.inference_mode():
      *_, twin_ops = gs._fused_plain(st.sd, s1.q, s1.u, torch.zeros_like(s1.u), None, hts1,
                                     return_ops=True)
    ptx = [ln.strip() for ln in _build.build_logs.get(k.name, "").splitlines()
           if "registers" in ln or "spill" in ln]
    note(f"  {name}: {k.source.count(chr(10))} lines, slots "
         f"{sorted(set(x.kind for x in st.sd.slots))} x {len(st.sd.slots)}; {k.ops_per_world} "
         f"operations (twin's tally {twin_ops}) and {k.loads_per_world} height loads per world; "
         f"nvcc {built.get(k.name, 0.0):.2f} s; ptxas: {' | '.join(ptx)}")
    if twin_ops != k.ops_per_world:
      fail(f"{name}: the twin's tally {twin_ops} is not the kernel's {k.ops_per_world}")
    src[name] = {"lines": k.source.count(chr(10)), "ops_per_world": k.ops_per_world,
                 "height_loads_per_world": k.loads_per_world, "build_s": built.get(k.name),
                 "ptxas": ptx}

  # ---- 23. each source against its twin and the K2 path ----------------------------------
  note(f"phase 23: K1c (debris) vs plain twin (float32), and vs the K2 path, B={B_check}, one "
       f"terrain per world")
  with torch.inference_mode():
    hts23 = hts64.repeat(B_check // 64, 1, 1)
    for name in DEBRIS_NAMES:
      sc, st = debris[name], steps[name]
      s = debris_states(torch, sc, hts23, seed=23)
      tau = torch.zeros_like(s.u)
      errs = [check_fused(torch, st, s, tau, None, f"{name}, drop states", hts23)[0]]
      check_against_k2(torch, sc, st, s, tau, None, f"{name}, K1c vs K2 path, drop", hts23)
      # the drop takes 90-150 steps to land: 200 steps in, the bodies touch
      for _ in range(200):
        s = st(s, tau, field_heights=hts23)
      _, touching = debris_contacts(torch, sc, s, hts23)
      note(f"  {name}, 200 steps in: {float(touching.float().mean()):.4f} of worlds in contact, "
           f"{near_vertical(torch, s.q)} with the axis within 1e-5 of vertical")
      if float(touching.float().mean()) < 0.5:
        fail(f"{name}: fewer than half the worlds are in contact 200 steps in")
      errs.append(check_fused(torch, st, s, tau, None, f"{name}, 200 steps in", hts23)[0])
      check_against_k2(torch, sc, st, s, tau, None, f"{name}, K1c vs K2 path, 200 steps in",
                       hts23)
      errs.append(check_tails(torch, st, s, tau, None, f"{name}, 200 steps in", hts23))
      src[name]["max_abs_err"] = max(errs)
    # the axis exactly vertical on a flat field (the downhill frame's
    # fallback, exact on every path), and the yawed cube's tied vertices
    flat = torch.zeros((B_up, 48, 24), device=dev)
    for name in ("cylinder", "cone", "cube"):
      sc, st = debris[name], steps[name]
      s = upright_states(torch, sc, name, B_up, seed=24)
      tau = torch.zeros_like(s.u)
      _, touching = debris_contacts(torch, sc, s, flat)
      if not bool(touching.all()):
        fail(f"{name}, upright: a world is not in contact")
      err = check_fused(torch, st, s, tau, None, f"{name}, axis vertical on a flat field",
                        flat)[0]
      check_against_k2(torch, sc, st, s, tau, None, f"{name}, upright, K1c vs K2 path", flat)
      if name != "cube":
        src[name]["max_abs_err"] = max(src[name]["max_abs_err"], err)

  # ---- 24. rollouts -----------------------------------------------------------------------
  note(f"phase 24: debris rollouts through K1c, B={B}, H={H}, the 64 terrains tiled")
  hts = hts64.repeat(B // 64, 1, 1)
  for name in DEBRIS_NAMES:
    st = steps[name]
    with torch.inference_mode():
      s = debris_states(torch, debris[name], hts, seed=23)
      tau = torch.zeros_like(s.u)
      st(s, tau, field_heights=hts)                   # warm-up (not counted)
      sync(torch, dev)
      reset_counts(gc, gs)
      t0 = time.perf_counter()
      for _ in range(H):
        s = st(s, tau, field_heights=hts)
      sync(torch, dev)
      t = time.perf_counter() - t0
      counts = read_counts(gc, gs)
    if counts != (0, H):
      fail(f"{name} rollouts launched (K2, K1) {counts} times for {H} steps")
    if not (torch.isfinite(s.q).all() and torch.isfinite(s.u).all()):
      fail(f"{name}: rollout state not finite")
    src[name]["launches"] = counts[1]
    src[name]["world_steps_per_s"] = B * H / t
    note(f"  {name}: {t:.3f} s, world-steps/s {B * H / t:.0f}, launches K2 {counts[0]} "
         f"K1 {counts[1]}")

  # ---- 25. the drop settles ---------------------------------------------------------------
  note(f"phase 25: the drop settles, {n_settle} steps ({n_settle * 0.002:.0f} s), B={B}")
  for name in DEBRIS_NAMES:
    sc, st = debris[name], steps[name]
    with torch.inference_mode():
      s = debris_states(torch, sc, hts, seed=23)
      tau = torch.zeros_like(s.u)
      t0 = time.perf_counter()
      gates, bad, _, _ = settle_gates(torch, sc, lambda x: st(x, tau, field_heights=hts), s, hts,
                                      n_settle)
    gates["seconds"] = time.perf_counter() - t0
    src[name]["settle"] = gates
    note(f"  {name}: {gates}")
    if bool(bad.any()):
      fail(f"{name}: {int(bad.sum())} of {B} worlds fail the settle gates: {gates}")

  # ---- 26. times --------------------------------------------------------------------------
  note(f"phase 26: K1c (debris) times at B={B}, 2048, {B_small} and 384")
  for name in DEBRIS_NAMES:
    sc, st = debris[name], steps[name]
    lib = _build.load(st.kernel.name)
    times = {}
    with torch.inference_mode():
      for b in (B, 2048, B_small, 384):
        hb = hts[:b].contiguous()
        sb = debris_states(torch, sc, hb, seed=26)
        for _ in range(200):                          # landed
          sb = st(sb, torch.zeros_like(sb.u), field_heights=hb)
        taub = torch.zeros_like(sb.u)
        qo, uo = torch.empty_like(sb.q), torch.empty_like(sb.u)
        ptrs = [sb.q.data_ptr(), sb.u.data_ptr(), taub.data_ptr(), None]
        times[b] = (
            time_cuda(torch, lambda: st(sb, taub, field_heights=hb), 20),
            time_cuda(torch, lambda: lib.fused_step_launch(
                *ptrs, hb.data_ptr(), hb.stride(0), qo.data_ptr(), uo.data_ptr(), b, stream), 20))
        if b == B:
          plain_ms = time_cuda(torch, lambda: gs._fused_plain(st.sd, sb.q, sb.u, taub, None, hb),
                               2)
    nbytes, nops = gs.fused_step_cost(st.sd, B, st.kernel.ops_per_world,
                                      st.kernel.loads_per_world)
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = nops / H100_F32_OPS_PER_S * 1e3
    src[name].update(ms=times[B][0], kernel_only_ms=times[B][1], plain_ms=plain_ms,
                     bound_ms=max(t_bytes, t_ops),
                     bound_by="bytes" if t_bytes >= t_ops else "operations",
                     ptxas=source_figures(gs, _build, st.kernel),
                     **{f"{k}_b{b}": times[b][i] for b in times if b != B
                        for i, k in enumerate(("ms", "kernel_only_ms"))})
    note(f"  {name}: B={B}: wrapper {times[B][0]:.3f} ms (kernel alone {times[B][1]:.3f} ms), "
         f"plain twin {plain_ms:.3f} ms; bound {max(t_bytes, t_ops):.4f} ms "
         f"({nbytes / 1e6:.1f} MB -> {t_bytes:.4f} ms, {nops / 1e9:.2f} GFLOP -> "
         f"{t_ops:.4f} ms); " + "; ".join(
             f"B={b}: wrapper {times[b][0]:.3f} ms (kernel alone {times[b][1]:.3f} ms)"
             for b in times if b != B))
    note(f"  {name}: {src[name]['ptxas']}")

  # the entry's top-level numbers are the rock's (the widest source); every
  # source's own are under "sources"
  top = src["mesh"]
  return {
      "name": "fused_step (K1c, hm_cylpt/hm_conept/hm_mesh slots: cylinder and cone probes in "
              "a runtime downhill frame, the 4 deepest of a mesh's vertex probes; cone_solve "
              "K3 inlined)",
      "route": "cuda",
      "source": "raisimlib_torch/ops/gpu_step.py",
      "template": "raisimlib_torch/csrc/fused_step.cuh",
      "replaces": "raisimlib_tpu/ops/pallas_step.py:995",
      "top_level": "mesh",
      "launches": sum(x["launches"] for x in src.values() if "launches" in x),
      "max_abs_err": max(x["max_abs_err"] for x in src.values() if "max_abs_err" in x),
      "ms": top["ms"],
      "kernel_only_ms": top["kernel_only_ms"],
      "plain_ms": top["plain_ms"],
      "bound_ms": top["bound_ms"],
      "bound_by": top["bound_by"],
      "library_ms": None,
      "ops_per_world": top["ops_per_world"],
      "sources": {n: src[n] for n in DEBRIS_NAMES},
  }


# Atlas (BASELINE config 5) has 32 plane_pt slots: the 8 corners of its
# pelvis, torso and two feet boxes. Standing and settling, a few of them sit
# within 1e-7 m of touching in some worlds, and an f32 rounding (FMA in the
# kernel, none in the twin, another assembly on the K2 path) puts such a
# corner on either side: that world's impulses then differ by up to ~0.3 on
# u. On an H100, 0-2 worlds of 1024 per step did so at steps 0-42 from
# three seeds of perturbed standing states (PERF.md, section 6), each with a
# contact within 3e-8 m of its activation or with the f64 reference siding
# with one of the two f32 paths.
# So for Atlas at most this share of the worlds may pass the ceiling (and
# the K2 path's bounds); the tight tier (99% of worlds) is unchanged.
ATLAS_BRANCH_SHARE = 0.005


def atlas_states(torch, scene, q0, B, seed, steps=0, step=None):
  """B robots as examples/atlas_batch.py makes them (N(0, 0.01) on every q
  entry, a torch.Generator seeded `seed`), the PD hold's targets and zero
  torques; then `steps` steps of `step(s, tau, pd)`."""
  from raisimlib_torch.examples import atlas_batch as ex_atlas

  s = ex_atlas.batch_states(scene, q0, B, torch.Generator(device="cuda").manual_seed(seed))
  pd = torch.zeros((B, scene.model.nv), device="cuda")
  pd[:, 6:] = q0[7:]
  tau = torch.zeros_like(pd)
  for _ in range(steps):
    s = step(s, tau, pd)
  return s, tau, pd


def near_touching(torch, scene, s, tol=1e-6):
  """How many worlds hold a contact slot within `tol` m of touching (the
  port's pure narrow phase on states s)."""
  from raisimlib_torch.ops import collision as coll
  from raisimlib_torch.ops import dynamics

  c = coll.collide(scene.geoms, scene.pairs, dynamics.fk(scene.model, s.q))
  return int((c.depth.abs() < tol).any(1).sum())


def atlas_golden_scene(torch, g):
  """The Atlas scenario's world with the golden's per-dof gains, on the card."""
  from raisimlib_torch import scenarios

  world, _ = scenarios.build_world(scenarios.load("atlas_batch"))
  f32 = dict(dtype=torch.float32, device="cuda")
  return world.compile().set_pd_gains(torch.tensor(g["kp"], **f32), torch.tensor(g["kd"], **f32))


def atlas_golden(torch, g, step_for, label):
  """Replay tests/goldens/atlas_settle.npz (50 steps, f32) through
  `step_for(scene)(state, pd)` on a batch of one world and hold it to the
  Atlas gate of utils/parity.py (torques within 1e-3 of the 300 N m limit,
  the base within 2e-3 m). Returns max|dtau|."""
  from raisimlib_torch.utils import parity

  scene = atlas_golden_scene(torch, g)
  f32 = dict(dtype=torch.float32, device="cuda")
  s = scene.init_state(q=torch.tensor(g["q0"][None], **f32), u=torch.tensor(g["u0"][None], **f32))
  stepfn = step_for(scene)
  qs, us = [], []
  with torch.inference_mode():
    for tgt in g["pd_targets"]:
      s = stepfn(s, torch.tensor(tgt[None], **f32))
      qs.append(s.q[0])
      us.append(s.u[0])
    qs, us = torch.stack(qs).cpu().numpy(), torch.stack(us).cpu().numpy()
  dtau, dbase = parity.atlas_deviation(qs, us, g)
  note(f"  {label}: {len(qs)} steps: max|dtau| {dtau.max():.3e} N m (step {int(dtau.argmax())}, "
       f"gate {parity.ATLAS_TORQUE_REL * float(g['torque_limit'])}), max|d base| "
       f"{dbase.max():.3e} m (gate {parity.ATLAS_BASE_GATE})")
  failures = parity.atlas_gate_failures(qs, us, g)
  if failures:
    fail(f"{label} Atlas gate: " + "; ".join(failures))
  return float(dtau.max())


def run_example(torch, gc, gs, mod, label):
  """`mod.run()` at full size (its own gates assert) with the launch counts
  set to 0 just before and read just after: K1 once per physics step, K2
  never. Returns (record, K1 launches)."""
  note(f"  {label}: python3 -m {mod.__name__}")
  reset_counts(gc, gs)
  res = mod.run()
  counts = read_counts(gc, gs)
  note(f"  {label}: launches K2 {counts[0]} K1 {counts[1]} for {res['physics_steps']} physics "
       f"steps; step path {res['step_path']}")
  if counts != (0, res["physics_steps"]) or res["step_path"] != "K1":
    fail(f"{label} launched (K2, K1) {counts} times for {res['physics_steps']} physics steps "
         f"(step path {res['step_path']})")
  return res, counts[1]


def kernel_alone_ms(torch, _build, stream, st, s, pd=None, hts=None, reps=50):
  """Mean ms of one launch of `st`'s kernel alone (no wrapper) on the states
  s (and PD targets pd, per-world heights hts), by CUDA events."""
  B = s.q.shape[0]
  lib = _build.load(st.kernel.name)
  tau = torch.zeros_like(s.u)
  qo, uo = torch.empty_like(s.q), torch.empty_like(s.u)
  ins = [s.q.contiguous(), s.u.contiguous(), tau] + ([pd.contiguous()] if pd is not None else [])
  hp = (hts.contiguous().data_ptr(), hts[0].numel()) if hts is not None else (None, 0)
  ptrs = [x.data_ptr() for x in ins] + ([None] if pd is None else [])
  return time_cuda(torch, lambda: lib.fused_step_launch(*ptrs, *hp, qo.data_ptr(), uo.data_ptr(),
                                                        B, stream), reps)


def example_shares(torch, _build, stream, scen_steps, res_bal, res_trot, res_stack):
  """Where each example's timed loop goes: its K1 launches at each batch
  size times the kernel's time alone there, as a share of the loop's wall
  time. Returns {example: {...}}."""
  from raisimlib_torch import scenarios

  out = {}
  st = scen_steps["anymal_balance"]
  sc = st.scene
  ticks, H, K = res_bal["ticks"], res_bal["horizon"], res_bal["samples"]
  sub = scenarios.load("anymal_balance")["controller"]["substeps"]
  with torch.inference_mode():
    ms = {b: kernel_alone_ms(torch, _build, stream, st, *standing_states(torch, sc, b, seed=31)[:2])
          for b in (K, 1)}
  wall = ticks / res_bal["mpc_solves_per_s"]
  busy = ticks * sub * (H * ms[K] + ms[1]) / 1e3
  out["anymal_balance"] = {"kernel_ms_b%d" % b: v for b, v in ms.items()}
  out["anymal_balance"].update(wall_s=wall, kernel_share=busy / wall)

  st = scen_steps["anymal_trot_heightmap"]
  sc = st.scene
  E, ticks, H, K = (res_trot["n_terrains"], res_trot["ticks"], res_trot["horizon"],
                    res_trot["samples"])
  sub = scenarios.load("anymal_trot_heightmap")["controller"]["substeps"]
  with torch.inference_mode():
    hts = make_terrains(torch, E)
    ms = {}
    for b in (E * K, E):
      hb = hts.repeat_interleave(b // E, 0)
      s, pd, _ = terrain_states(torch, sc, hb, seed=32)
      ms[b] = kernel_alone_ms(torch, _build, stream, st, s, pd, hb)
  wall = E * ticks / res_trot["mpc_solves_per_s"]
  busy = ticks * sub * (H * ms[E * K] + ms[E]) / 1e3
  out["anymal_trot_heightmap"] = {"kernel_ms_b%d" % b: v for b, v in ms.items()}
  out["anymal_trot_heightmap"].update(wall_s=wall, kernel_share=busy / wall)

  st = scen_steps["sphere_box_stack"]
  with torch.inference_mode():
    s = loose_states(torch, st.scene, 1, seed=33, kick=(3, STACK["kick_m_s"]))
    ms1 = kernel_alone_ms(torch, _build, stream, st, s)
  out["sphere_box_stack"] = {"kernel_ms_b1": ms1, "wall_s": res_stack["wall_s"],
                             "kernel_share": res_stack["physics_steps"] * ms1 / 1e3
                             / res_stack["wall_s"]}
  for name, x in out.items():
    note(f"  {name}: " + ", ".join(f"{k} {v:.4f}" for k, v in x.items()))
  return out


def run_entry_points(torch, gs, gc, _build, built, stream, atlas, scen_steps, same_source):
  """Phases 27-33: the port's scenarios and examples (raisimlib_torch/
  scenarios, raisimlib_torch/examples), Atlas's K1 at nv = 29 among them.
  Returns the kernels line's Atlas entry and the examples' records."""
  from raisimlib_torch.examples import anymal_balance as ex_balance
  from raisimlib_torch.examples import anymal_trot_heightmap as ex_trot
  from raisimlib_torch.examples import atlas_batch as ex_atlas
  from raisimlib_torch.examples import sphere_box_stack as ex_stack

  at_scene, at_q0, at_step = atlas
  k = at_step.kernel
  sd = at_step.sd

  # ---- 27. the scenarios ------------------------------------------------------------------
  note("phase 27: the port's scenarios (raisimlib_torch/scenarios/*.json) through "
       "scenarios.build_scene")
  for name, st in scen_steps.items():
    x = st.sd
    note(f"  {name}: nq {x.nq}, nv {x.nv}, slots {sorted(set(y.kind for y in x.slots))} x "
         f"{len(x.slots)}, {len(x.limits)} limit rows; kernel {st.kernel.name}, the source of "
         f"{same_source[name]}")
  with torch.inference_mode():
    s1, tau1, pd1 = atlas_states(torch, at_scene, at_q0, 1, seed=27)
    *_, twin_ops = gs._fused_plain(sd, s1.q, s1.u, tau1, pd1, return_ops=True)
  at_fig = source_figures(gs, _build, k)
  note(f"  atlas_batch: nq {sd.nq}, nv {sd.nv}, slots {sorted(set(y.kind for y in sd.slots))} x "
       f"{len(sd.slots)}, {len(sd.limits)} limit rows; K1 source {k.source.count(chr(10))} lines, "
       f"{k.ops_per_world} operations per world (twin's tally {twin_ops}); nvcc "
       f"{built.get(k.name, 0.0):.2f} s; {at_fig}")
  if twin_ops != k.ops_per_world:
    fail(f"Atlas: the twin's tally {twin_ops} is not the kernel's {k.ops_per_world}")

  # ---- 28. Atlas's K1 against its twin and the K2 path ----------------------------------------
  B_at = 1024
  note(f"phase 28: Atlas's K1 (nv = 29) vs plain twin (float32), and vs the K2 path, B={B_at}")
  share = ATLAS_BRANCH_SHARE
  errs = []
  with torch.inference_mode():
    s, tau, pd = atlas_states(torch, at_scene, at_q0, B_at, seed=28)
    errs.append(check_fused(torch, at_step, s, tau, pd, "Atlas, perturbed standing states",
                            ceiling_share=share)[0])
    check_against_k2(torch, at_scene, at_step, s, tau, pd, "Atlas, K1 vs K2 path, standing",
                     share=share)
    for _ in range(20):
      s = at_step(s, tau, pd)
    note(f"  20 steps in: pelvis z [{float(s.q[:, 2].min()):.4f}, {float(s.q[:, 2].max()):.4f}]; "
         f"{near_touching(torch, at_scene, s)} worlds with a contact within 1e-6 m of touching")
    errs.append(check_fused(torch, at_step, s, tau, pd, "Atlas, 20 steps into a rollout",
                            ceiling_share=share)[0])
    check_against_k2(torch, at_scene, at_step, s, tau, pd, "Atlas, K1 vs K2 path, 20 steps in",
                     share=share)
    s, tau, pd = atlas_states(torch, at_scene, at_q0, 1037, seed=29, steps=20, step=at_step)
    errs.append(check_tails(torch, at_step, s, tau, pd, "Atlas, B=1037, 20 steps in",
                            ceiling_share=share))

  # ---- 29. the Atlas golden through K1 and the K2 path ---------------------------------------
  note("phase 29: Atlas golden (tests/goldens/atlas_settle.npz, 50 steps) through K1 and the "
       "K2 path")
  here = os.path.dirname(os.path.abspath(__file__))
  g = np.load(os.path.join(here, "tests", "goldens", "atlas_settle.npz"))

  def fused_atlas(sc):
    step = gs.make_step_batch_fused(sc)
    return lambda st, p: step(st, torch.zeros_like(p), p)

  golden = {"K1": atlas_golden(torch, g, fused_atlas, "K1"),
            "K2": atlas_golden(torch, g, lambda sc: lambda st, p: sc.step_batch(st, pd_target=p),
                               "K2")}

  # ---- 30. the Atlas example, then Atlas's K1 times --------------------------------------------
  note("phase 30: examples.atlas_batch.run() (B = 1024 x H = 50), then Atlas's K1 times")
  res_at, at_launches = run_example(torch, gc, gs, ex_atlas, "atlas_batch")
  lib = _build.load(k.name)
  times = {}
  with torch.inference_mode():
    for b, seed in ((B_at, 30), (2048, 31), (16384, 32)):
      sb, taub, pdb = atlas_states(torch, at_scene, at_q0, b, seed=seed, steps=20, step=at_step)
      qo, uo = torch.empty_like(sb.q), torch.empty_like(sb.u)
      ptrs = [x.data_ptr() for x in (sb.q, sb.u, taub, pdb)]
      times[b] = (time_cuda(torch, lambda: at_step(sb, taub, pdb), 20),
                  time_cuda(torch, lambda: lib.fused_step_launch(
                      *ptrs, None, 0, qo.data_ptr(), uo.data_ptr(), b, stream), 20))
      if b == B_at:
        plain_ms = time_cuda(torch, lambda: gs._fused_plain(sd, sb.q, sb.u, taub, pdb), 2)
  nbytes, nops = gs.fused_step_cost(sd, B_at, k.ops_per_world)
  t_bytes, t_ops = nbytes / H100_BYTES_PER_S * 1e3, nops / H100_F32_OPS_PER_S * 1e3
  note(f"  B={B_at}: wrapper {times[B_at][0]:.3f} ms (kernel alone {times[B_at][1]:.3f} ms), plain "
       f"twin {plain_ms:.3f} ms; bound {max(t_bytes, t_ops):.4f} ms ({nbytes / 1e6:.2f} MB -> "
       f"{t_bytes:.4f} ms, {nops / 1e9:.2f} GFLOP -> {t_ops:.4f} ms); " + "; ".join(
           f"B={b}: wrapper {times[b][0]:.3f} ms (kernel alone {times[b][1]:.3f} ms)"
           for b in times if b != B_at))
  note(f"  Atlas's K1 source: {at_fig}")

  # ---- 31-33. the other examples ---------------------------------------------------------------
  note("phase 31: examples.anymal_balance.run() (MPPI, K = 128, H = 25, 100 ticks, through K1a)")
  res_bal, bal_launches = run_example(torch, gc, gs, ex_balance, "anymal_balance")
  note("phase 32: examples.anymal_trot_heightmap.run() (4 terrains x 96 samples, H = 16, 150 "
       "ticks, through K1c)")
  res_trot, trot_launches = run_example(torch, gc, gs, ex_trot, "anymal_trot_heightmap")
  note("phase 33: examples.sphere_box_stack.run() (10 s of one world, through K1b at B = 1)")
  res_stack, stack_launches = run_example(torch, gc, gs, ex_stack, "sphere_box_stack")
  note("  the examples' kernel time (each batch's launches x the kernel alone there) against "
       "their timed loops")
  shares = example_shares(torch, _build, stream, scen_steps, res_bal, res_trot, res_stack)
  res_at["kernel_share"] = res_at["horizon"] * times[B_at][1] / 1e3 * res_at["rollouts_per_s"] / B_at

  entry = {
      "name": "fused_step (K1a at nv = 29: Atlas, 32 plane_pt slots + 23 limit rows; "
              "cone_solve K3 inlined)",
      "route": "cuda",
      "source": "raisimlib_torch/ops/gpu_step.py",
      "template": "raisimlib_torch/csrc/fused_step.cuh",
      "replaces": "raisimlib_tpu/ops/pallas_step.py:995",
      "launches": at_launches,
      "max_abs_err": max(errs),
      "ms": times[B_at][0],
      "kernel_only_ms": times[B_at][1],
      "plain_ms": plain_ms,
      "bound_ms": max(t_bytes, t_ops),
      "bound_by": "bytes" if t_bytes >= t_ops else "operations",
      "library_ms": None,
      "batch": B_at,
      **{f"{key}_b{b}": times[b][i] for b in times if b != B_at
         for i, key in enumerate(("ms", "kernel_only_ms"))},
      "ops_per_world": k.ops_per_world,
      "build_s": built.get(k.name),
      "ptxas": at_fig,
      "golden_max_dtau": golden,
  }
  for name, x in shares.items():
    {"anymal_balance": res_bal, "anymal_trot_heightmap": res_trot,
     "sphere_box_stack": res_stack}[name]["kernel_share"] = x["kernel_share"]
  examples = {"atlas_batch": res_at, "anymal_balance": res_bal,
              "anymal_trot_heightmap": res_trot, "sphere_box_stack": res_stack}
  launches = {"anymal_balance": bal_launches, "anymal_trot_heightmap": trot_launches,
              "sphere_box_stack": stack_launches}
  return entry, examples, launches


# ---- phases 34-37: iLQR (mpc/ilqr.py) ---------------------------------------------------------

# bench.py::bench_anymal_ilqr's settings: 8 envs, H = 50, 8 iterations,
# kernel-FD derivatives (fd_eps 2e-2); a solve launches K1 H times for the
# nominal rollout and, per iteration, once for the FD stack (2 nd E H rows,
# or (nd + 1) E H with fd_order 1) and H times for the line search (E *
# n_alpha rows)
ILQR_ENVS, ILQR_H, ILQR_ITERS = 8, 50, 8
ILQR_EXACT_LIMIT_S = 60.0      # phase 37 runs E = 2 where one E = 8 solve would take longer


def ilqr_launches(H=ILQR_H, iters=ILQR_ITERS, fd=True):
  """K1 launches of one solve: the rollout, then per iteration the FD stack
  (none on the exact path) and the line search."""
  return H + iters * (int(fd) + H)


def run_cartpole(torch, gc, gs):
  """Phase 34: examples.cartpole_swingup.run() at full size (40 iterations,
  H = 50, f32 on the card), no kernel launched; its plan against
  tests/goldens/cartpole_swingup.npz under tests/test_parity.py's gate.
  Returns the record."""
  from raisimlib_torch.examples import cartpole_swingup as ex_cart

  here = os.path.dirname(os.path.abspath(__file__))
  g = np.load(os.path.join(here, "tests", "goldens", "cartpole_swingup.npz"))
  note("  cartpole_swingup: python3 -m raisimlib_torch.examples.cartpole_swingup")
  reset_counts(gc, gs)
  res = ex_cart.run()
  counts = read_counts(gc, gs)
  dU = float(np.abs(res.pop("U").astype(np.float64) - g["U"]).max())
  dcost = abs(res["cost"] - float(g["cost"]))
  res.update(max_abs_dU_golden=dU, cost_err_golden=dcost)
  note(f"  cartpole_swingup: solve_s {res['solve_s']:.3f} (warm-up {res['compile_s']:.3f}); "
       f"max|dU| {dU:.3e} against the golden (gate 1e-3), cost {res['cost']:.6f} (golden "
       f"{float(g['cost']):.6f}, gate 1e-4), final theta {res['final_theta']:.4f}; launches K2 "
       f"{counts[0]} K1 {counts[1]}")
  if counts != (0, 0):
    fail(f"the cartpole example launched (K2, K1) {counts} times: its dynamics are plain PyTorch")
  if dU > 1e-3 or dcost > 1e-4 or abs(res["final_theta"] - np.pi) >= 0.5:
    fail("the cartpole swing-up misses the golden gate")
  return res


def ilqr_starts(torch, q0, seed, dev, n_env=ILQR_ENVS, H=ILQR_H):
  """bench.py's mk(seed) on `dev`: (x0s (n_env, 37), U0s (n_env, H, 12))."""
  from raisimlib_torch.mpc import balance_ilqr as bi

  return tuple(torch.tensor(a, device=dev) for a in bi.balance_starts(q0, n_env, H, seed))


def solve_balance(torch, gc, gs, scene, q0, config, seeds, dyn_diff=None, n_env=ILQR_ENVS):
  """Synchronised ilqr_batch solves of the balance problem (one per seed)
  through make_contact_dyn_batch (K1 on the card), the launch counts set to
  0 just before the first and read just after the last; then each start's
  initial cost (the rollout of its plan, outside the counts). Returns
  (seconds per solve, (K2, K1) counts, solutions, initial costs)."""
  from raisimlib_torch.mpc import balance_ilqr as bi
  from raisimlib_torch.mpc.ilqr import ILQRConfig, ilqr_batch
  from raisimlib_torch.mpc.state_map import make_contact_dyn_batch

  dyn_fast, _, _ = make_contact_dyn_batch(scene, bi.CONTROL_DT, 1, use_pd=True,
                                            fused="require")
  dev = scene.device
  rc, fc, _ = bi.balance_costs(q0, device=dev)
  starts = [ilqr_starts(torch, q0, s, dev, n_env) for s in seeds]
  times, sols = [], []
  sync(torch, dev)
  reset_counts(gc, gs)
  for x0s, U0s in starts:
    t0 = time.perf_counter()
    sols.append(ilqr_batch(dyn_fast, dyn_diff, rc, fc, x0s, U0s, config))
    sync(torch, dev)
    times.append(time.perf_counter() - t0)
  counts = read_counts(gc, gs)
  none = ILQRConfig(iters=0, deriv="fd")
  c0s = [ilqr_batch(dyn_fast, None, rc, fc, x0s, U0s, none).cost for x0s, U0s in starts]
  return times, counts, sols, c0s


def ilqr_gates(torch, label, sols, c0s):
  """Every env's cost trace finite and non-increasing (from its initial
  cost on). Returns the mean ratio of final to initial cost, and bench.py's
  (final over the first iteration's)."""
  ratios, bench_ratios = [], []
  for sol, c0 in zip(sols, c0s):
    ct = torch.cat([c0[:, None], sol.cost_trace], 1)
    if not bool(torch.isfinite(ct).all()):
      fail(f"{label}: a cost trace is not finite")
    if not bool((ct[:, 1:] <= ct[:, :-1]).all()):
      fail(f"{label}: a cost trace rises")
    ratios.append(float((sol.cost / c0).mean()))
    bench_ratios.append(float((ct[:, -1] / ct[:, 1]).mean()))
  return float(np.mean(ratios)), float(np.mean(bench_ratios))


def ilqr_check_rows(torch, q0, dyn_step, dev):
  """Phase 36's inputs on the iLQR scene: the FD batch of an iteration (2
  nd rows around each of E * H = 400 base rows, fd_rows' layout) and a
  line-search batch of E * n_alpha = 64 rows, from the 8 starts of mk(7)
  after 20 steps of the standing targets (the feet settled into contact:
  the standing pose itself holds them within rounding of activation, where
  K1 and its twin may branch apart as on Atlas). Returns {B: (state, tau,
  pd)}."""
  from raisimlib_torch.mpc.ilqr import fd_rows
  from raisimlib_torch.ops.integrator import State

  x0s, U0s = ilqr_starts(torch, q0, 7, dev)
  x = x0s
  for _ in range(20):
    x = dyn_step(x, U0s[:, 0], 0)
  xs = [x]
  for t in range(ILQR_H):
    xs.append(dyn_step(xs[-1], U0s[:, t], t))
  X = torch.stack(xs[:-1], 1).reshape(-1, 37)
  gen = torch.Generator(device=dev).manual_seed(36)
  U = U0s.reshape(-1, 12) + 0.02 * torch.randn(X.shape[0], 12, device=dev, generator=gen)
  rows = {2 * 49 * X.shape[0]: fd_rows(X, U, 2e-2, 2), 49 * X.shape[0] + X.shape[0]:
          fd_rows(X, U, 2e-2, 1), 64: (X[10::ILQR_H].repeat_interleave(8, 0), U[:64]),
          ILQR_ENVS: (X[::ILQR_H], U[::ILQR_H])}
  out = {}
  for b, (Xb, Ub) in rows.items():
    pd = torch.zeros((b, 18), device=dev)
    pd[:, 6:] = Ub
    out[b] = (State(q=Xb[:, :19].contiguous(), u=Xb[:, 19:].contiguous(),
                    t=torch.zeros(b, device=dev)), torch.zeros_like(pd), pd)
  return out


def run_ilqr(torch, gs, gc, _build, built, stream, il_step):
  """Phases 34-37: the cartpole swing-up (config 1), and the ANYmal balance
  iLQR of bench.py::bench_anymal_ilqr through K1 at its new batches: the FD
  stacks (39,200 rows, 20,000 with fd_order 1), the line search (64) and
  the rollout (8). Returns the kernels line's entry for the iLQR scene's
  K1 and the records."""
  from raisimlib_torch.models import anymal
  from raisimlib_torch.mpc import balance_ilqr as bi
  from raisimlib_torch.mpc.ilqr import ILQRConfig, fd_rows
  from raisimlib_torch.mpc.state_map import make_contact_dyn_batch
  from raisimlib_torch.ops.integrator import State

  scene = il_step.scene
  q0 = anymal.standing_q()
  k = il_step.kernel
  rec = {}

  # ---- 34. the cartpole swing-up ----------------------------------------------------------------
  note("phase 34: examples.cartpole_swingup.run() (BASELINE config 1: iLQR, H = 50, 40 "
       "iterations, f32 on the card) against tests/goldens/cartpole_swingup.npz")
  rec["cartpole_swingup"] = run_cartpole(torch, gc, gs)

  # ---- 35. the ANYmal balance iLQR, kernel-FD through K1 -----------------------------------------
  B_fd = 2 * 49 * ILQR_ENVS * ILQR_H
  note(f"phase 35: ANYmal balance iLQR (bench.py::bench_anymal_ilqr: {ILQR_ENVS} envs, H = "
       f"{ILQR_H}, {ILQR_ITERS} iterations, deriv='fd', fd_eps 2e-2) through K1: FD stacks of "
       f"{B_fd} rows (fd_order 2) and {B_fd // 2 + ILQR_ENVS * ILQR_H} (fd_order 1)")
  fd = {}
  for order in (2, 1):
    cfg = ILQRConfig(iters=ILQR_ITERS, deriv="fd", fd_order=order)
    if order == 2:                                 # the warm-up solve, mk(0)
      solve_balance(torch, gc, gs, scene, q0, cfg, (0,))
    times, counts, sols, c0s = solve_balance(torch, gc, gs, scene, q0, cfg, (1, 2))
    ratio, bench_ratio = ilqr_gates(torch, f"fd_order {order}", sols, c0s)
    per = ilqr_launches()
    fd[order] = {"solves_per_s": ILQR_ENVS / min(times), "seconds": times, "cost_ratio": ratio,
                 "cost_ratio_bench": bench_ratio, "k1_launches": counts[1],
                 "k1_launches_per_solve": counts[1] / len(times),
                 "final_cost_mean": float(torch.cat([s.cost for s in sols]).mean())}
    note(f"  fd_order {order}: iLQR solves/s {fd[order]['solves_per_s']:.2f} (solves of "
         f"{', '.join(f'{t:.3f}' for t in times)} s); mean cost ratio final/initial {ratio:.4f} "
         f"(bench.py's final/first iteration {bench_ratio:.4f}); mean final cost "
         f"{fd[order]['final_cost_mean']:.5f}; launches K2 {counts[0]} K1 {counts[1]} "
         f"({counts[1] / len(times):.0f} a solve, expected {per})")
    if counts != (0, per * len(times)):
      fail(f"the iLQR (fd_order {order}) launched (K2, K1) {counts} times for {len(times)} "
           f"solves of {per} steps")
  if fd[2]["cost_ratio"] > 0.5:
    fail(f"the kernel-FD iLQR kept {fd[2]['cost_ratio']:.3f} of its initial cost (gate 0.5)")
  # the main path's first FD batch holds the standing pose itself (t = 0):
  # how many of its rows have a contact within 1e-6 m of activation
  sol0 = solve_balance(torch, gc, gs, scene, q0, ILQRConfig(iters=0, deriv="fd"), (1,))[2][0]
  with torch.inference_mode():
    Xf, _ = fd_rows(sol0.X[:, :-1].reshape(-1, 37), sol0.U.reshape(-1, 12), 2e-2, 2)
    near = near_touching(torch, scene, State(q=Xf[:, :19], u=Xf[:, 19:], t=Xf[:, 0]))
  note(f"  the first iteration's FD batch: {near} of {Xf.shape[0]} rows with a contact within "
       f"1e-6 m of activation (the standing pose at t = 0)")

  # ---- 36. K1 at the iLQR scene against its twin ------------------------------------------------
  note(f"phase 36: the iLQR scene's K1 (ANYmal, dt = 0.01 s) vs plain twin (float32) at "
       f"B={B_fd} (an FD stack) and 64 (a line-search batch), and its times")
  dyn_step, _, _ = make_contact_dyn_batch(scene, bi.CONTROL_DT, 1, use_pd=True,
                                            fused="require")
  errs, times = [], {}
  with torch.inference_mode():
    rows = ilqr_check_rows(torch, q0, dyn_step, scene.device)
    s, tau, pd = rows[B_fd]
    errs.append(check_fused(torch, il_step, s, tau, pd, f"iLQR FD stack, B={B_fd}")[0])
    errs.append(check_tails(torch, il_step, s, tau, pd, f"iLQR FD stack, B={B_fd}"))
    s, tau, pd = rows[64]
    errs.append(check_fused(torch, il_step, s, tau, pd, "iLQR line search, B=64")[0])
    a, b = il_step(s, tau, pd), il_step(s, tau, pd)
    sync(torch, scene.device)
    if not (torch.equal(a.q, b.q) and torch.equal(a.u, b.u)):
      fail("iLQR line search, B=64: two launches on the same inputs differ")
    note("  iLQR line search, B=64: twice, bitwise equal")
    for b_, (s, tau, pd) in rows.items():
      times[b_] = (time_cuda(torch, lambda: il_step(s, tau, pd), 20),
                   kernel_alone_ms(torch, _build, stream, il_step, s, pd, reps=20))
    s, tau, pd = rows[B_fd]
    plain_ms = time_cuda(torch, lambda: gs._fused_plain(il_step.sd, s.q, s.u, tau, pd), 2)
  bounds = {}
  for b_ in times:
    nbytes, nops = gs.fused_step_cost(il_step.sd, b_, k.ops_per_world)
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S * 1e3, nops / H100_F32_OPS_PER_S * 1e3
    bounds[b_] = (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")
    note(f"  B={b_}: wrapper {times[b_][0]:.3f} ms, kernel alone {times[b_][1]:.3f} ms; bound "
         f"{bounds[b_][0]:.4f} ms ({nbytes / 1e6:.2f} MB -> {t_bytes:.4f} ms, {nops / 1e9:.3f} "
         f"GFLOP -> {t_ops:.4f} ms)" + (f"; plain twin {plain_ms:.3f} ms" if b_ == B_fd else ""))
  B_fd1 = B_fd // 2 + ILQR_ENVS * ILQR_H
  for order, b_fd in ((2, B_fd), (1, B_fd1)):
    busy = (ILQR_H * times[ILQR_ENVS][1]
            + ILQR_ITERS * (times[b_fd][1] + ILQR_H * times[64][1])) / 1e3
    fd[order]["k1_share"] = busy / min(fd[order]["seconds"])
    fd[order]["k1_seconds_per_solve"] = busy
    note(f"  fd_order {order}: K1 alone {1e3 * busy:.1f} ms a solve ({ILQR_H} x B={ILQR_ENVS} + "
         f"{ILQR_ITERS} x (B={b_fd} + {ILQR_H} x B=64)), {100 * fd[order]['k1_share']:.1f}% of "
         f"the {1e3 * min(fd[order]['seconds']):.1f} ms wall")
  note(f"  K1 source: {source_figures(gs, _build, k)}")

  # ---- 37. the exact path: jvp derivatives through the pure path ----------------------------------
  note("phase 37: the same problem with deriv='jvp' (exact Jacobians: one forward-mode pass "
       "through the pure path, make_contact_dyn_batch(use_kernel=False), on the card)")
  dyn_diff, _, _ = make_contact_dyn_batch(scene, bi.CONTROL_DT, 1, use_pd=True, use_kernel=False)
  probe, _, _, _ = solve_balance(torch, gc, gs, scene, q0, ILQRConfig(iters=1, deriv="jvp"),
                                 (1,), dyn_diff)
  n_env = ILQR_ENVS if probe[0] * ILQR_ITERS <= ILQR_EXACT_LIMIT_S else 2
  note(f"  one iteration at E={ILQR_ENVS}: {probe[0]:.2f} s; solving at E={n_env}"
       + ("" if n_env == ILQR_ENVS else f" (a solve at E={ILQR_ENVS} would take over "
          f"{ILQR_EXACT_LIMIT_S:.0f} s)"))
  times_j, counts, sols, c0s = solve_balance(
      torch, gc, gs, scene, q0, ILQRConfig(iters=ILQR_ITERS, deriv="jvp"), (1,), dyn_diff, n_env)
  ratio_j, _ = ilqr_gates(torch, "deriv 'jvp'", sols, c0s)
  per = ilqr_launches(fd=False)
  exact = {"n_env": n_env, "solves_per_s": n_env / times_j[0], "seconds": times_j[0],
           "cost_ratio": ratio_j, "final_cost_mean": float(sols[0].cost.mean()),
           "k1_launches": counts[1]}
  note(f"  exact path: iLQR solves/s {exact['solves_per_s']:.3f} ({times_j[0]:.2f} s at "
       f"E={n_env}); mean final cost {exact['final_cost_mean']:.5f} (kernel-FD, fd_order 2: "
       f"{fd[2]['final_cost_mean']:.5f}; the same starts, mk(1){'' if n_env == ILQR_ENVS else ' cut to 2 envs'}); "
       f"mean cost ratio {ratio_j:.4f}; launches K2 {counts[0]} K1 {counts[1]} (expected {per})")
  if counts != (0, per):
    fail(f"the exact-path iLQR launched (K2, K1) {counts} times for {per} steps")

  rec["anymal_ilqr"] = {"fd_order_2": fd[2], "fd_order_1": fd[1], "jvp": exact}
  entry = {
      "name": "fused_step (K1a, the iLQR scene: ANYmal at dt = 0.01 s, kp 100, kd 2; cone_solve "
              "K3 inlined)",
      "route": "cuda",
      "source": "raisimlib_torch/ops/gpu_step.py",
      "template": "raisimlib_torch/csrc/fused_step.cuh",
      "replaces": "raisimlib_tpu/ops/pallas_step.py:995",
      "launches": fd[2]["k1_launches"] + fd[1]["k1_launches"] + exact["k1_launches"],
      "launches_fd_order_2": fd[2]["k1_launches"],
      "launches_fd_order_1": fd[1]["k1_launches"],
      "launches_jvp": exact["k1_launches"],
      "max_abs_err": max(errs),
      "ms": times[B_fd][0],
      "kernel_only_ms": times[B_fd][1],
      "plain_ms": plain_ms,
      "bound_ms": bounds[B_fd][0],
      "bound_by": bounds[B_fd][1],
      "library_ms": None,
      "batch": B_fd,
      **{f"{key}_b{b_}": v for b_ in times if b_ != B_fd
         for key, v in (("ms", times[b_][0]), ("kernel_only_ms", times[b_][1]),
                        ("bound_ms", bounds[b_][0]))},
      "ops_per_world": k.ops_per_world,
      "build_s": built.get(k.name),
      "ptxas": source_figures(gs, _build, k),
  }
  return entry, rec


# phases 38-41: scenes outside K1's class (as in the JAX package's _analyze),
# on the K2 path (Scene.step_batch -> pipeline.step_batch -> K2): box-box,
# capsule-capsule, the support-function pairs, sphere-cylinder, sphere-mesh,
# a compound, wires, pins, compliant wires. The add_* functions take a World
# of the port or of the JAX package (the calls are the same); k2_q0 gives a
# scene's nominal q0 (the mixed drop's capsules are laid down by their
# quaternions).
TOWER_HE = ((0.25, 0.25, 0.12), (0.2, 0.2, 0.1), (0.15, 0.15, 0.08))
TOWER_DT, PILE_DT, MIXED_DT, TRIO_DT = 0.002, 0.002, 0.002, 0.001
# the pile: box k in cell (k % 2, k // 4, (k // 2) % 2) of a 2 x 2 x 2 grid,
# pitch 0.31 m, so that the first 4 boxes are two stacks of two; half
# extents 0.10-0.15 m, 1 kg each; the bottom layer 1 cm above the ground,
# every gap at least 1 cm
PILE_HE = ((0.15, 0.13, 0.12), (0.12, 0.15, 0.14), (0.10, 0.12, 0.11), (0.14, 0.11, 0.10),
           (0.13, 0.14, 0.15), (0.11, 0.10, 0.13), (0.15, 0.12, 0.10), (0.12, 0.13, 0.12))
PILE_PITCH = 0.31
BOX_TOP = 0.4                   # the mixed drop's static box (0.5, 0.5, 0.2) at z 0.2
# the wire pendulum, the pinned box and the compliant wire of the JAX
# package's tests/test_constraints.py, 2 m apart in y so that no pair touches
TRIO_WIRE = dict(anchor=(0.0, 0.0, 1.6), length=0.85)
TRIO_PIN = dict(anchor=(0.0, 2.0, 1.0), corner=(-0.2, 0.0, 0.0))
TRIO_SPRING = dict(anchor=(0.0, -2.0, 1.5), length=0.5, stiffness=200.0, damping=30.0)


def _quat(axis, angle):
  axis = np.asarray(axis, np.float64) / np.linalg.norm(axis)
  return np.r_[np.cos(angle / 2), np.sin(angle / 2) * axis]


def add_box_tower(world):
  """The three boxes of the JAX package's tests/test_boxbox.py stack, 1 kg
  each, 2 mm apart, on the ground. Returns their rest heights."""
  world.add_ground()
  rest, z = [], 0.0
  for i, he in enumerate(TOWER_HE):
    z += he[2]
    world.add_box(he, mass=1.0, pos=(0.005 * i, -0.003 * i, z + 0.002), name=f"b{i}")
    rest.append(z)
    z += he[2]
  return rest


def add_box_pile(world, n=8):
  """n of the 8 boxes of the pile on the ground (PILE_HE, PILE_PITCH)."""
  world.add_ground()
  for k in range(n):
    i, j, layer = k % 2, k // 4, (k // 2) % 2
    he = PILE_HE[k]
    z = 0.01 + he[2] if layer == 0 else 0.01 + 2 * max(h[2] for h in PILE_HE) + 0.01 + he[2]
    world.add_box(he, mass=1.0, pos=((i - 0.5) * PILE_PITCH, (j - 0.5) * PILE_PITCH, z),
                  name=f"p{k}")


MIXED_PARTS = ("capsules", "cylinder", "cone", "rock", "dumbbell")


def add_mixed_drop(world, parts=MIXED_PARTS):
  """A static box (0.5, 0.5, 0.2) at z 0.2 on the ground and, dropped on
  it (`parts`, each optional): two capsules (r 0.1, half-length 0.3) laid
  across each other, 8 cm apart; an upright cylinder with a sphere over it,
  a cone and the rock in the corners; a dumbbell compound of two spheres and
  a capsule."""
  world.add_ground()
  world.add_box((0.5, 0.5, 0.2), 0.0, pos=(0.0, 0.0, 0.2), static=True)
  if "capsules" in parts:
    world.add_capsule(0.1, 0.3, 1.0, pos=(0.0, 0.0, BOX_TOP + 0.11), name="capsule_low")
    world.add_capsule(0.1, 0.3, 1.0, pos=(0.0, 0.0, BOX_TOP + 0.36), name="capsule_high")
  if "cylinder" in parts:
    world.add_cylinder(0.1, 0.15, 1.0, pos=(0.33, -0.33, BOX_TOP + 0.16), name="cylinder")
    world.add_sphere(0.08, 1.0, pos=(0.33, -0.33, BOX_TOP + 0.43), name="ball")
  if "cone" in parts:
    world.add_cone(0.12, 0.2, 1.0, pos=(0.33, 0.33, BOX_TOP + 0.06), name="cone")
  if "rock" in parts:
    world.add_mesh(rock_vertices(), 2.0, pos=(-0.33, -0.33, BOX_TOP + 0.09), name="rock")
  if "dumbbell" in parts:
    along_x = [[0.0, 0.0, 1.0], [0.0, 1.0, 0.0], [-1.0, 0.0, 0.0]]
    world.add_compound([dict(type="sphere", params=[0.05], pos=(-0.1, 0.0, 0.0)),
                        dict(type="sphere", params=[0.05], pos=(0.1, 0.0, 0.0)),
                        dict(type="capsule", params=[0.025, 0.1], rot=along_x)],
                       1.0, name="dumbbell", pos=(-0.33, 0.33, BOX_TOP + 0.06))
  return parts


def mixed_drop_q0(q_init, parts=MIXED_PARTS):
  """The mixed drop's q0: the lower capsule along x, the upper along y."""
  q = np.array(q_init, np.float64)
  if "capsules" in parts:
    q[3:7] = _quat((0.0, 1.0, 0.0), np.pi / 2)
    q[10:14] = _quat((1.0, 0.0, 0.0), -np.pi / 2)
  return q


def add_constraint_trio(world):
  """A sphere on a stiff wire from a world anchor, a box pinned at a corner
  to the world, a sphere on a compliant wire (the JAX package's
  tests/test_constraints.py scenes), 2 m apart."""
  h = world.add_sphere(0.05, mass=1.0, pos=(0.6, 0.0, 1.0), name="wire_ball")
  world.add_stiff_wire(-1, TRIO_WIRE["anchor"], h.body_start, (0.0, 0.0, 0.0),
                       length=TRIO_WIRE["length"])
  hb = world.add_box((0.2, 0.05, 0.05), mass=1.0, pos=(0.2, 2.0, 1.0), name="pinned_box")
  world.add_pin(hb.body_start, TRIO_PIN["corner"], -1, TRIO_PIN["anchor"])
  hc = world.add_sphere(0.05, mass=1.0, pos=(0.0, -2.0, 0.95), name="spring_ball")
  world.add_compliant_wire(-1, TRIO_SPRING["anchor"], hc.body_start, (0.0, 0.0, 0.0),
                           length=TRIO_SPRING["length"], stiffness=TRIO_SPRING["stiffness"],
                           damping=TRIO_SPRING["damping"])


K2_SCENES = {"tower": (add_box_tower, TOWER_DT), "pile": (add_box_pile, PILE_DT),
             "mixed": (add_mixed_drop, MIXED_DT), "trio": (add_constraint_trio, TRIO_DT)}


def k2_world(World, name, cut=None, **kw):
  """The world of K2 scene `name` in the World class given (the port's or
  the JAX package's; kw: its dtype and device), cut to `cut` (the pile's
  box count, the mixed drop's parts; None: the whole scene). Returns
  (world, what the add_* function returned)."""
  add, dt = K2_SCENES[name]
  world = World(dt=dt, **kw)
  info = add(world) if cut is None else add(world, cut)
  return world, info


def k2_q0(name, q_init, info):
  """Scene `name`'s nominal q0 (numpy) from its model's q_init."""
  q0 = np.asarray(q_init, np.float64)
  return mixed_drop_q0(q0, info) if name == "mixed" else q0


def k2_scene(torch, name, cut=None, device=None, dtype=None):
  """The port's Scene of K2 scene `name` (no joint limits: its bodies are
  free), its q0 (numpy) and what the add_* function returned."""
  from raisimlib_torch.world import World

  world, info = k2_world(World, name, cut, dtype=dtype or torch.float32, device=device)
  scene = world.compile(joint_limits=False)
  return scene, k2_q0(name, scene.model.q_init.cpu().double().numpy(), info), info


def k2_states(torch, scene, q0, B, seed, dxy=5e-3, dv=0.0):
  """B states at q0, each free body moved by x, y offsets drawn within
  +-dxy and given linear velocities within +-dv (uniform, from a seeded
  CPU torch.Generator)."""
  from raisimlib_torch.models.model import JointType

  m = scene.model
  g = torch.Generator().manual_seed(seed)
  q = torch.tensor(q0, dtype=torch.float64).repeat(B, 1)
  u = torch.zeros((B, m.nv), dtype=torch.float64)
  for b in range(m.nb):
    if JointType(m.joint_types[b]) == JointType.FREE:
      qa, va = m.q_adr[b], m.v_adr[b]
      q[:, qa:qa + 2] += dxy * (2.0 * torch.rand((B, 2), generator=g, dtype=torch.float64) - 1.0)
      u[:, va + 3:va + 6] = dv * (2.0 * torch.rand((B, 3), generator=g, dtype=torch.float64)
                                  - 1.0)
  dt = dict(dtype=m.dtype, device=scene.device)
  return scene.init_state(q=q.to(**dt), u=u.to(**dt))


def k2_gates(torch, name, scene, qs, s_end, info):
  """The scene's gates on the stored states `qs` (list of (step, q)) and the
  end state; returns a dict of figures and a list of failures."""
  from raisimlib_torch.ops import collision as coll
  from raisimlib_torch.ops import dynamics

  q, u = s_end.q, s_end.u
  figs, bad = {}, []
  if not (torch.isfinite(q).all() and torch.isfinite(u).all()):
    return figs, ["state not finite"]
  nb = scene.model.nb
  if name == "tower":
    dz = max(float((q[:, 7 * i + 2] - z).abs().max()) for i, z in enumerate(info))
    dxy = max(float(q[:, 7 * i:7 * i + 2].abs().max()) for i in range(nb))
    figs.update(max_dz_from_rest=dz, max_abs_xy=dxy)
    if dz >= 0.02 or dxy >= 0.08:
      bad.append(f"a box left its rest height by {dz:.4f} m or slid to |x|,|y| = {dxy:.4f} m")
  elif name == "pile":
    deepest = 0.0
    for _, qk in qs:
      c = coll.collide(scene.geoms, scene.pairs, dynamics.fk(scene.model, qk))
      deepest = max(deepest, float((c.depth * c.active).max()))
    speed = max(float(u[:, 6 * i + 3:6 * i + 6].norm(dim=1).max()) for i in range(nb))
    figs.update(deepest_active_contact=deepest, max_box_speed=speed)
    if deepest > 0.01 or speed >= 0.1:
      bad.append(f"an active contact {deepest:.4f} m deep or a box at {speed:.4f} m/s")
  elif name == "mixed":
    z_min = float(min(q[:, 7 * i + 2].min() for i in range(nb)))
    figs.update(min_com_z=z_min)
    if z_min < BOX_TOP - 0.01:
      bad.append(f"a body at z {z_min:.4f} m, below the static box's top less 1 cm")
  else:
    anchor = torch.tensor(TRIO_WIRE["anchor"], dtype=q.dtype, device=q.device)
    pin = torch.tensor(TRIO_PIN["anchor"], dtype=q.dtype, device=q.device)
    corner = torch.tensor(TRIO_PIN["corner"], dtype=q.dtype, device=q.device)
    from raisimlib_torch.ops import spatial as sp
    wire_len = max(float((qk[:, 0:3] - anchor).norm(dim=1).max()) for _, qk in qs)
    x_min = torch.stack([qk[:, 0] for _, qk in qs]).amin(0)
    pin_err = max(float((qk[:, 7:10] + sp.quat_rotate(qk[:, 10:14], corner.expand(qk.shape[0], 3))
                         - pin).norm(dim=1).max()) for _, qk in qs)
    z_box = torch.stack([qk[:, 9] for _, qk in qs]).amin(0)
    k, c, L = (TRIO_SPRING[x] for x in ("stiffness", "damping", "length"))
    z_eq = TRIO_SPRING["anchor"][2] - (L + 9.81 / k)
    spring_dz = float((q[:, 16] - z_eq).abs().max())
    figs.update(max_wire_length=wire_len, max_min_wire_x=float(x_min.max()),
                max_pin_error=pin_err, max_min_box_z=float(z_box.max()),
                max_spring_dz=spring_dz)
    if wire_len > TRIO_WIRE["length"] + 5e-3 or float(x_min.max()) >= -0.3:
      bad.append(f"wire length {wire_len:.4f} m, or a sphere that never crossed x < -0.3")
    if pin_err >= 2e-3 or float(z_box.max()) >= 0.92:
      bad.append(f"pin error {pin_err:.2e} m, or a box that never dropped below 0.92")
    if spring_dz >= 5e-3:
      bad.append(f"the compliant sphere ends {spring_dz:.4f} m from z_eq {z_eq:.4f}")
  return figs, bad


# (phase, label, scene, worlds, steps, stored every n steps)
K2_PHASES = ((38, "box tower", "tower", 4096, 1000, 100),
             (39, "box pile", "pile", 1024, 750, 50),
             (40, "mixed drop", "mixed", 4096, 500, 100),
             (41, "constraints", "trio", 4096, 1000, 10))


def time_once(torch, fn):
  """ms of one call by CUDA events (for the plain twin, whose loops make a
  repeat cost seconds)."""
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  stop = torch.cuda.Event(enable_timing=True)
  start.record()
  fn()
  stop.record()
  torch.cuda.synchronize()
  return start.elapsed_time(stop)


# a build of K2 that takes the device-memory layout at every shape
# (MF_DEVICE_ROWS), registered by register_device_build, for phases 38-41
MF_DEVICE_BUILD = "mf_solve_device_rows"


def register_device_build(_build):
  """Register MF_DEVICE_BUILD (built with the others by _build.build())."""
  spec = _build.KERNELS["mf_solve"]
  _build.KERNELS[MF_DEVICE_BUILD] = dict(source=spec["source"],
                                         defines=spec["defines"] + ("-DMF_DEVICE_ROWS",),
                                         symbols=spec["symbols"])


def launch_mf(torch, gc, lib, ins, rows, cfg):
  """One launch of the K2 build `lib` on kernel_inputs' tensors: (u, lam)."""
  B, nc, _, nv = ins[0].shape
  u = torch.empty((B, nv), dtype=torch.float32, device=ins[0].device)
  lam = torch.empty((B, nc, 3), dtype=torch.float32, device=ins[0].device)
  rc = lib.mf_solve_launch(*(x.data_ptr() for x in ins), rows.data_ptr(), u.data_ptr(),
                           lam.data_ptr(), B, nc, nv, gc._used_rows(cfg.row_kinds), cfg.sweeps,
                           cfg.n_grid, torch.cuda.current_stream().cuda_stream)
  if rc != 0:
    fail(f"K2 ({lib}) launch failed: cudaError {rc}")
  return u, lam


def run_k2_scenes(torch, gs, gc, card):
  """Phases 38-41: each scene of K2_PHASES through Scene.step_batch (K2 once
  a step, K1 never), its gates, K2 against its twin on the solver inputs of
  three steps (the first, a third of the way, the last) and its tails and
  relaunches bitwise on the last; K2's times alone and through its wrapper
  beside its bound, the plain twin's, the K2 path's step; and, where the
  rows are staged, the device-memory layout's build on the same inputs
  (bitwise, and its time). Returns the kernels line's entries and the
  records."""
  from raisimlib_torch import _build
  from raisimlib_torch.ops import pipeline

  entries, recs = [], {}
  for phase, label, name, B, steps, every in K2_PHASES:
    t_phase = time.perf_counter()
    with torch.inference_mode():
      scene, q0, info = k2_scene(torch, name)
      # the trio's bodies start where their wires and pin put them, with
      # velocities; the others' positions are moved
      s = (k2_states(torch, scene, q0, B, seed=phase, dxy=0.0, dv=0.01) if name == "trio"
           else k2_states(torch, scene, q0, B, seed=phase))
      kinds = pipeline.scene_row_kinds(scene)
      nc, nv = len(kinds), scene.model.nv
      nrow = gc._used_rows(kinds)
      wpb, smem, layout = gc.block_shape(nc, nv, kinds, 32)
      rows_b = 4 * 2 * nrow * nv
      note(f"phase {phase}: {label} on the K2 path: B={B}, nc={nc}, nv={nv}, kinds "
           f"{ {k: kinds.count(k) for k in set(kinds)} }; the world's J and W rows "
           f"{rows_b} B, {smem // wpb} B of shared memory a world in the {layout} layout "
           f"({wpb} world(s) a block)")
      checks = {0, steps // 3, steps - 1}
      saved, qs = {}, []
      scene.step_batch(s)                            # warm-up
      torch.cuda.synchronize()
      reset_counts(gc, gs)
      t0 = time.perf_counter()
      for k in range(steps):
        if k in checks:
          saved[k] = (s.q.clone(), s.u.clone())
        if k % every == 0:
          qs.append((k, s.q.clone()))
        s = scene.step_batch(s)
      torch.cuda.synchronize()
      t_run = time.perf_counter() - t0
      counts = read_counts(gc, gs)
    if counts != (steps, 0):
      fail(f"{label}: the K2 path launched (K2, K1) {counts} times for {steps} steps")
    with torch.inference_mode():
      figs, bad = k2_gates(torch, name, scene, qs, s, info)
    note(f"  {steps} steps in {t_run:.2f} s: {1e3 * t_run / steps:.3f} ms a step, "
         f"world-steps/s {B * steps / t_run:.0f}, launches K2 {counts[0]} K1 {counts[1]}; "
         f"gates: {figs}")
    if bad:
      fail(f"{label}: " + "; ".join(bad))
    from raisimlib_torch.ops.integrator import State

    errs = []
    with torch.inference_mode():
      for k in sorted(saved):
        sk = State(q=saved[k][0], u=saved[k][1], t=s.t)
        args, cfg = pipeline.solver_inputs(scene, sk, torch.zeros_like(sk.u))
        args = list(args)
        plain = []
        plain_ms = time_once(torch, lambda: plain.append(gc._mf_plain(*args, cfg)))
        errs.append(check_kernel(torch, args, cfg.row_kinds, f"{label}, step {k}",
                                 plain_out=plain[0])[0])
      check_k2_tails(torch, args, cfg.row_kinds, f"{label}, step {max(saved)}", False)
      ins, rows_t = gc.kernel_inputs(*args, cfg)
      reps = 20 if B * nc <= 4096 * 64 else 5
      ms = time_cuda(torch, lambda: gc.solve_dynamics_batch(*args, cfg), reps)
      kernel_ms = time_cuda(torch, lambda: gc.launch_kernel(ins, rows_t, cfg), reps)
      # the same solve in the device-memory layout (a build that takes it at
      # every shape): the same bits where both fit, and its time beside
      other = {}
      if layout == "shared":
        lib = _build.load(MF_DEVICE_BUILD)
        out = launch_mf(torch, gc, lib, ins, rows_t, cfg)
        torch.cuda.synchronize()
        ref = gc.launch_kernel(ins, rows_t, cfg)
        bitwise = all(torch.equal(a, b) for a, b in zip(out, ref))
        errs.append(check_kernel(torch, args, cfg.row_kinds, f"{label}, the device layout",
                                 kernel_out=out, plain_out=plain[0])[0])
        other = dict(device_layout_kernel_ms=time_cuda(
            torch, lambda: launch_mf(torch, gc, lib, ins, rows_t, cfg), reps),
            device_layout_bitwise=bitwise)
        note(f"  the device-memory layout on the same inputs: "
             f"{'bitwise equal' if bitwise else 'not bitwise equal, within the tiers'}, "
             f"{other['device_layout_kernel_ms']:.3f} ms alone")
      step_ms = time_cuda(torch, lambda: scene.step_batch(sk), 5)
    nbytes, nops = gc.mf_solve_cost(B, nc, nv, cfg.row_kinds, cfg.sweeps, cfg.n_grid)
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S * 1e3, nops / H100_F32_OPS_PER_S * 1e3
    note(f"  K2 at B={B}: wrapper {ms:.3f} ms (kernel alone {kernel_ms:.3f} ms, the {layout} "
         f"layout), plain twin {plain_ms:.1f} ms; bound {max(t_bytes, t_ops):.4f} ms "
         f"({nbytes / 1e6:.1f} MB -> {t_bytes:.4f} ms, {nops / 1e9:.3f} GFLOP -> {t_ops:.4f} "
         f"ms); the K2 path's step {step_ms:.3f} ms; phase {time.perf_counter() - t_phase:.1f} "
         f"s; card: {card}")
    entries.append({
        "name": f"mf_solve (K2) at the {label}: nc={nc}, nv={nv}, the {layout} layout",
        "route": "cuda",
        "source": "raisimlib_torch/csrc/mf_solve.cu",
        "body": "raisimlib_torch/csrc/mf_solve.cuh",
        "replaces": "raisimlib_tpu/ops/pallas_contact.py:164",
        "launches": counts[0],
        "max_abs_err": max(errs),
        "ms": ms,
        "kernel_only_ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
        "batch": B, "nc": nc, "nv": nv, "layout": layout, "worlds_per_block": wpb,
        "smem_block_bytes": smem, "row_bytes_per_world": rows_b,
        "step_ms": step_ms, "world_steps_per_s": B * steps / t_run, **other,
    })
    recs[name] = dict(figs, steps=steps, batch=B, seconds=t_run,
                      phase_seconds=time.perf_counter() - t_phase)
  return entries, recs


# ---- phases 42-48: the parallel layer, checkpoint and profiling at world size 1 ----------------


def equal_bits(torch, a, b):
  return a.shape == b.shape and bool(torch.equal(a, b))


def run_parallel(torch, gs, gc, scene, s0, pd, H, t_roll1, il_step, card):
  """Phases 42-48 at world size 1, one rank over NCCL in this process
  (parallel.init_distributed; the group is destroyed before the last line):
  the sharded rollout through K1 and through K2, the sharded iLQR and the
  sharded MPPI through K1, the sharded contact solve on a K2 step's
  problem, atlas_batch --scaling, a checkpoint of a card State, and the
  profiling helpers. Returns the record."""
  import torch.distributed as dist

  from raisimlib_torch import parallel
  from raisimlib_torch.examples import atlas_batch as ex_atlas
  from raisimlib_torch.mpc import balance_ilqr as bi
  from raisimlib_torch.mpc import mppi
  from raisimlib_torch.mpc.ilqr import ILQRConfig, ilqr_batch
  from raisimlib_torch.mpc.state_map import make_contact_dyn_batch
  from raisimlib_torch.ops import pipeline
  from raisimlib_torch.ops.integrator import State
  from raisimlib_torch.utils import checkpoint, profiling

  rec = {}
  t_phase = time.perf_counter()
  dev = parallel.init_distributed()
  if dist.get_backend() != "nccl" or dist.get_world_size() != 1 or dev.type != "cuda":
    fail(f"init_distributed: backend {dist.get_backend()}, world {dist.get_world_size()}, "
         f"device {dev}")
  mesh = parallel.make_mesh()
  B = s0.q.shape[0]
  nv = scene.model.nv

  # ---- 42. the sharded rollout, K1 then K2 ----------------------------------------------------
  note(f"phase 42: parallel.make_sharded_rollout of the flat ANYmal, B={B} x H={H}, one NCCL "
       "rank: through K1 (fused='auto'), then through K2 (fused='never'), each bitwise against "
       "the unsharded rollout through the same step")
  taus = pd[:, None].expand(B, H, nv)
  zero = torch.zeros_like(pd)
  k1 = gs.make_step_batch_fused(scene)
  for fused_mode, step, label, want in (
      ("auto", lambda st: k1(st, zero, pd), "K1", (0, H)),
      ("never", lambda st: scene.step_batch(st, zero, pd), "K2", (H, 0))):
    with torch.inference_mode():
      rollout = parallel.make_sharded_rollout(scene, mesh, use_pd=True, fused=fused_mode)
      if rollout.fused != (label == "K1"):
        fail(f"the sharded rollout with fused={fused_mode!r} took the wrong step")
      shard_s, shard_t = parallel.shard_batch(mesh, (s0, taus))
      rollout(shard_s, shard_t)          # warm-up: the allocator then holds the q trace
      torch.cuda.synchronize()
      reset_counts(gc, gs)
      t0 = time.perf_counter()
      final, qs = rollout(shard_s, shard_t)
      torch.cuda.synchronize()
      t_sh = time.perf_counter() - t0
      counts = read_counts(gc, gs)
      final, qs = parallel.gather_batch(mesh, (final.q, qs))
      s, ref_qs = s0, []
      for _ in range(H):
        s = step(s)
        ref_qs.append(s.q)
      ref_qs = torch.stack(ref_qs, 1)
    if counts != want:
      fail(f"the sharded rollout ({label}) launched (K2, K1) {counts} times for {H} steps")
    if not (equal_bits(torch, final, s.q) and equal_bits(torch, qs, ref_qs)):
      fail(f"the sharded rollout ({label}) is not bitwise the unsharded one: max |dq| "
           f"{float((qs - ref_qs).abs().max()):.3e}")
    note(f"  {label}: rollouts/s {B / t_sh:.1f} (phase 8, unsharded through K1: "
         f"{B / t_roll1:.1f}); launches K2 {counts[0]} K1 {counts[1]}; final q and the q "
         f"trace ({tuple(qs.shape)}) bitwise equal to the unsharded rollout")
    rec[f"sharded_rollout_{label}"] = {"rollouts_per_s": B / t_sh, "seconds": t_sh,
                                       "launches": counts, "bitwise": True}
  rec["unsharded_k1_rollouts_per_s"] = B / t_roll1

  # ---- 43. the sharded iLQR --------------------------------------------------------------------
  note(f"phase 43: parallel.make_sharded_ilqr of phase 35's ANYmal balance iLQR ({ILQR_ENVS} "
       f"envs, H={ILQR_H}, {ILQR_ITERS} iterations, kernel-FD through K1), a warm-up solve, "
       "then one against ilqr_batch")
  from raisimlib_torch.models import anymal

  il_scene = il_step.scene
  q0 = anymal.standing_q()
  dyn_fast, _, _ = make_contact_dyn_batch(il_scene, bi.CONTROL_DT, 1, use_pd=True,
                                          fused="require")
  rc, fc, q_stand = bi.balance_costs(q0, device=il_scene.device)
  cfg = ILQRConfig(iters=ILQR_ITERS, deriv="fd", fd_order=2)
  solve = parallel.make_sharded_ilqr(None, rc, fc, mesh, cfg, dyn_fast=dyn_fast)
  solve(*parallel.shard_batch(mesh, ilqr_starts(torch, q0, 0, il_scene.device)))  # warm-up
  x0s, U0s = ilqr_starts(torch, q0, 1, il_scene.device)
  torch.cuda.synchronize()
  reset_counts(gc, gs)
  t0 = time.perf_counter()
  U, cost, metrics = solve(*parallel.shard_batch(mesh, (x0s, U0s)))
  torch.cuda.synchronize()
  t_il = time.perf_counter() - t0
  counts = read_counts(gc, gs)
  ref = ilqr_batch(dyn_fast, None, rc, fc, x0s, U0s, cfg)
  if counts != (0, ilqr_launches()):
    fail(f"the sharded iLQR launched (K2, K1) {counts} times, not (0, {ilqr_launches()})")
  if not (equal_bits(torch, U, ref.U) and equal_bits(torch, cost, ref.cost)):
    fail(f"the sharded iLQR is not bitwise ilqr_batch: max |dU| "
         f"{float((U - ref.U).abs().max()):.3e}")
  if not (float(metrics["mean_cost"]) == float(ref.cost.mean())
          and float(metrics["max_cost"]) == float(ref.cost.max())):
    fail(f"the sharded iLQR's metrics {metrics} are not ilqr_batch's mean and max")
  note(f"  iLQR solves/s {ILQR_ENVS / t_il:.2f} (one solve of {ILQR_ENVS} envs in {t_il:.3f} s);"
       f" launches K2 {counts[0]} K1 {counts[1]}; U and costs bitwise ilqr_batch's; mean_cost "
       f"{float(metrics['mean_cost']):.5f}, max_cost {float(metrics['max_cost']):.5f}")
  rec["sharded_ilqr"] = {"solves_per_s": ILQR_ENVS / t_il, "seconds": t_il, "launches": counts,
                         "mean_cost": float(metrics["mean_cost"]),
                         "max_cost": float(metrics["max_cost"]), "bitwise": True}

  # ---- 44. the sharded MPPI --------------------------------------------------------------------
  E, K, HM, iters = 4, 64, 20, 2
  note(f"phase 44: parallel.make_sharded_mppi on the balance scene through K1 ({E} scenarios x "
       f"{K} samples, H={HM}, {iters} iterations), against mppi.receding_horizon on the same "
       "noise")
  cfg_m = mppi.MPPIConfig(n_samples=K, sigma=0.1, temperature=0.3)
  gen = torch.Generator(device=il_scene.device).manual_seed(44)
  eps = cfg_m.sigma * torch.randn((E, iters, K, HM, 12), generator=gen, device=il_scene.device)
  x0m, U0m = x0s[:E], q_stand.expand(E, HM, 12).contiguous()
  msolve = parallel.make_sharded_mppi(dyn_fast, rc, fc, mesh, iters, cfg_m)
  with torch.inference_mode():
    x_l, U_l, eps_l = parallel.shard_batch(mesh, (x0m, U0m, eps))
    torch.cuda.synchronize()
    reset_counts(gc, gs)
    t0 = time.perf_counter()
    Um, costm, mean_m = msolve(x_l, U_l, eps_white=eps_l)
    torch.cuda.synchronize()
    t_m = time.perf_counter() - t0
    counts = read_counts(gc, gs)
    Ur, costr, _ = mppi.receding_horizon(dyn_fast, rc, fc, x0m, U0m, None, iters, cfg_m,
                                         eps_white=eps)
  want = (0, iters * 2 * HM)
  if counts != want:
    fail(f"the sharded MPPI launched (K2, K1) {counts} times, not {want}")
  if not (equal_bits(torch, Um, Ur) and equal_bits(torch, costm, costr)
          and float(mean_m) == float(costr.mean())):
    fail(f"the sharded MPPI is not receding_horizon's: max |dU| {float((Um - Ur).abs().max()):.3e}")
  note(f"  MPPI solves/s {E / t_m:.2f}; launches K2 {counts[0]} K1 {counts[1]} (the samples, "
       f"then the updated plans, each iteration); U and costs bitwise receding_horizon's; mean "
       f"cost {float(mean_m):.5f}")
  rec["sharded_mppi"] = {"solves_per_s": E / t_m, "seconds": t_m, "launches": counts,
                         "mean_cost": float(mean_m), "bitwise": True}

  # ---- 45. the sharded contact solve --------------------------------------------------------------
  from raisimlib_torch.parallel.qp_shard import make_sharded_contact_solver

  note("phase 45: parallel.qp_shard at qp = 1 on the contact problem of a K2 step (ANYmal, 20 "
       "steps into a PD hold, f64 on the card), the Signorini and cone conditions")
  with torch.inference_mode():
    s = State(q=s0.q[:2], u=s0.u[:2], t=s0.t[:2])
    for _ in range(20):
      s = scene.step_batch(s, zero[:2], pd[:2])
    (G, c0, mu, active), _ = pipeline._pre_solve(scene, s, zero[:2], pd[:2])
    qmesh = parallel.Mesh(np.arange(1), ("qp",))
    qsolve = make_sharded_contact_solver(qmesh, qp_axis="qp", dp_axis=None, iters=128,
                                         omega=0.7)
    worst = {}
    for w in range(2):
      Gw, cw = G[w].double(), c0[w].double()
      lam = qsolve(Gw, cw, mu[w].double(), active[w].double())
      v = torch.einsum("ipjq,jq->ip", Gw, lam) + cw
      act = active[w] > 0.5
      closed = act & (lam[:, 2] > 1e-8)
      cone = (lam[:, :2].norm(dim=1) - mu[w].double() * lam[:, 2])[act]
      figs = {"n_active": int(act.sum()), "n_closed": int(closed.sum()),
              "min_lam_n": float(lam[act, 2].min()), "max_cone_excess": float(cone.max()),
              "min_v_n": float(v[act, 2].min()),
              "max_closed_v_n": float(v[closed, 2].abs().max()) if closed.any() else 0.0,
              "max_complementarity": float((lam[closed, 2] * v[closed, 2]).max())
              if closed.any() else 0.0}
      worst[w] = figs
      if not (figs["n_closed"] > 0 and figs["min_lam_n"] >= -1e-12
              and figs["max_cone_excess"] <= 1e-8 and figs["min_v_n"] >= -1e-6
              and figs["max_closed_v_n"] < 1e-4 and figs["max_complementarity"] < 1e-6):
        fail(f"the sharded contact solve, world {w}: {figs}")
  note(f"  {worst}")
  rec["sharded_contact_solve"] = worst

  # ---- 46. atlas_batch --scaling ----------------------------------------------------------------
  note("phase 46: examples.atlas_batch.run(scaling=True): the weak-scaling table at "
       "device_counts [1] (the world holds one rank)")
  from raisimlib_torch import scenarios

  Hs = int(os.environ.get("ATLAS_SCALING_H", scenarios.load("atlas_batch")["scaling"]["horizon"]))
  reset_counts(gc, gs)
  res = ex_atlas.run(scaling=True)
  counts = read_counts(gc, gs)
  rows = res["scaling"]
  # the example's rollouts, then the row's warm-up and its 3 timed repeats
  want = (0, res["physics_steps"] + (1 + 3) * Hs)
  if [r["n_devices"] for r in rows] != [1] or rows[0]["efficiency"] != 1.0 or counts != want:
    fail(f"atlas_batch --scaling: rows {rows}, launches (K2, K1) {counts}, not {want}")
  note(f"  one row: {rows[0]['throughput']:.1f} rollouts/s a rank, efficiency "
       f"{rows[0]['efficiency']}; launches K2 {counts[0]} K1 {counts[1]}")
  rec["atlas_scaling"] = {"rows": rows, "launches": counts}

  # ---- 47. checkpoint --------------------------------------------------------------------------
  note(f"phase 47: utils.checkpoint.save and restore of a B={B} card State")
  out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "metrics", "torch")
  path = os.path.join(out_dir, "chip_smoke_state.npz")
  t0 = time.perf_counter()
  checkpoint.save(path, s0, step=47)
  template = State(q=torch.zeros_like(s0.q), u=torch.zeros_like(s0.u), t=torch.zeros_like(s0.t))
  back, scalars = checkpoint.restore(path, template)
  t_ck = time.perf_counter() - t0
  size = os.path.getsize(path)
  os.remove(path)
  if not (all(equal_bits(torch, getattr(back, f), getattr(s0, f)) for f in ("q", "u", "t"))
          and back.q.device == s0.q.device and int(scalars["step"]) == 47):
    fail("the checkpoint of a card State did not come back bitwise on the card")
  note(f"  {size / 1e6:.2f} MB saved and restored in {t_ck:.3f} s, bitwise, on {back.q.device}")
  rec["checkpoint"] = {"bytes": size, "seconds": t_ck}

  # ---- 48. profiling -------------------------------------------------------------------------------
  note(f"phase 48: utils.profiling.trace on one K1 launch (B={B}), and "
       "tune_sweeps on the ANYmal scene (K2 path, 256 perturbed standing states)")
  with torch.inference_mode():
    logdir = os.path.join(out_dir, "chip_smoke_trace")
    profiling.trace(k1, s0, zero, pd, logdir=logdir)
    trace_file = os.path.join(logdir, "trace.json")
    with open(trace_file) as f:
      text = f.read()
    named = all(x in text for x in ("fused_step_kernel", '"k1.step"', '"k1.enqueue"'))
    kern = [e for e in profiling.trace.last.key_averages() if "fused_step_kernel" in e.key]
    dev_us = sum(getattr(e, "device_time_total", 0) for e in kern)
    size = os.path.getsize(trace_file)
    if not named or not kern:
      fail(f"the profiler's trace ({trace_file}, {size} B) does not name K1's kernel and "
           "its k1.step and k1.enqueue spans")
    st, pdt, _ = standing_states(torch, scene, 256, seed=48)
    sweeps, err = profiling.tune_sweeps(scene, st, torch.zeros_like(pdt), pdt)
  note(f"  trace {size} B names K1's kernel and its spans "
       f"({kern[0].key[:60]}), {dev_us / 1e3:.3f} ms of device time; tune_sweeps -> {sweeps} "
       f"sweeps (one-step max |du| {err:.2e} against 48 sweeps)")
  rec["profiling"] = {"trace_bytes": size, "k1_device_ms": dev_us / 1e3,
                      "tune_sweeps": [sweeps, err]}
  dist.destroy_process_group()
  rec["phase_seconds"] = time.perf_counter() - t_phase
  note(f"  phases 42-48: {rec['phase_seconds']:.1f} s; card: {card}")
  return rec



def main():
  import torch

  if not torch.cuda.is_available():
    fail("torch.cuda.is_available() is false: this smoke test needs a CUDA device")
  try:
    from raisimlib_torch import _build
    from raisimlib_torch.ops import contact as ct
    from raisimlib_torch.ops import gpu_contact as gc
    from raisimlib_torch.ops import gpu_step as gs
    from raisimlib_torch.ops import pipeline
  except ImportError as e:
    fail(f"cannot import the port (run from the repository root): {e}")
  t_start = time.perf_counter()

  # ---- 1. card and build ------------------------------------------------
  smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True, text=True,
                       timeout=60)
  card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"
  note(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
  scene = anymal_scene(torch)
  fused = gs.make_step_batch_fused(scene)
  kern = fused.kernel                                # registers the generated source
  note(f"K1 source for the ANYmal scene: {kern.source.count(chr(10))} lines, "
       f"{kern.ops_per_world} operations per world")
  tscene = anymal_scene(torch, terrain=True)
  fused_c = gs.make_step_batch_fused(tscene)
  kern_c = fused_c.kernel                            # K1c, built with the others
  # the gains are constants of the generated source: the trot scene (kp 120,
  # kd 3; phases 15, 16) has a kernel of its own, built here too, so that no
  # build falls inside a timed loop
  kern_trot = gs.make_step_batch_fused(anymal_scene(torch, kp=120.0, kd=3.0, terrain=True)).kernel
  # K1b: the sphere-box stack (phases 18-21) and phase 18's two other scenes
  sscene = stack_scene(torch)
  fused_b = gs.make_step_batch_fused(sscene, use_pd=False)
  kern_b = fused_b.kernel
  k1b_scenes = {"spheres_capsule": spheres_capsule_scene(torch),
                "static_box": static_box_scene(torch)}
  k1b_steps = {k: gs.make_step_batch_fused(sc, use_pd=False) for k, sc in k1b_scenes.items()}
  for st in k1b_steps.values():
    st.kernel
  # K1c's cylinder, cone and mesh slots: the debris scenes of phases 22-26
  # and the cube of phase 23's tie case
  debris = {n: debris_scene(torch, n) for n in DEBRIS_NAMES + ("cube",)}
  debris_steps = {n: gs.make_step_batch_fused(sc, use_pd=False) for n, sc in debris.items()}
  for st in debris_steps.values():
    st.kernel
  # the port's scenarios (phases 27-33): Atlas's K1 at nv = 29 (its own
  # kernel; the golden's gains are the scenario's), and the three other
  # examples' scenes, whose sources are those of the scenes above
  from raisimlib_torch import scenarios
  from raisimlib_torch.examples import atlas_batch as ex_atlas

  at_scene, at_q0, _ = ex_atlas.build_scene()
  at_step = gs.make_step_batch_fused(at_scene)
  at_step.kernel
  g_at = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "goldens",
                              "atlas_settle.npz"))
  gs.make_step_batch_fused(atlas_golden_scene(torch, g_at)).kernel
  scen_steps = {n: gs.make_step_batch_fused(scenarios.build_scene(scenarios.load(n))[0],
                                            use_pd=n != "sphere_box_stack")
                for n in ("anymal_balance", "anymal_trot_heightmap", "sphere_box_stack")}
  # the iLQR scene (phases 35-37): ANYmal at dt = 0.01 s, a source of its own
  from raisimlib_torch.mpc import balance_ilqr

  il_step = gs.make_step_batch_fused(balance_ilqr.balance_scene())
  il_step.kernel
  same_source = {n: {kern.name: "phase 7's flat scene", kern_trot.name: "phase 15's trot scene",
                     kern_b.name: "phase 18's stack"}.get(st.kernel.name, "no earlier scene")
                 for n, st in scen_steps.items()}
  register_device_build(_build)                      # phases 38-41
  t0 = time.perf_counter()
  built = _build.build(list(_build.KERNELS))     # the wide builds too: no nvcc in a timed phase
  note(f"build: {time.perf_counter() - t0:.2f} s in parallel; "
       + ", ".join(f"{n} {sec:.2f} s" for n, sec in built.items()))
  for name, log in _build.build_logs.items():
    for line in log.splitlines():
      if "registers" in line or "spill" in line or "error" in line:
        note(f"  ptxas[{name}]: {line.strip()}")
  note(f"K1b source for the stack scene: {kern_b.source.count(chr(10))} lines, "
       f"{kern_b.ops_per_world} operations per world, slots "
       f"{sorted(s.kind for s in fused_b.sd.slots)}; nvcc {built.get(kern_b.name, 0.0):.2f} s")
  for line in _build.build_logs.get(kern_b.name, "").splitlines():
    if "registers" in line or "spill" in line:
      note(f"  ptxas[K1b]: {line.strip()}")

  # ---- 2. K2 vs plain twin ---------------------------------------------------
  note("phase 2: K2 vs plain twin (float32)")
  kinds_any = pipeline.scene_row_kinds(scene)
  s, pd, q0 = standing_states(torch, scene, 4096, seed=1)
  with torch.inference_mode():
    args, cfg = pipeline.solver_inputs(scene, s, torch.zeros_like(pd), pd)
    anymal_err = check_kernel(torch, list(args), cfg.row_kinds, "ANYmal factors")[0]
    for nc in (1, 4, 12):
      check_kernel(torch, random_problem(torch, 1037, nc, seed=nc), (), f"random nc={nc}")
    kinds = ("cone", "lin", "cone", "bilateral")
    check_kernel(torch, random_problem(torch, 1037, 4, seed=7, kinds=kinds), kinds,
                 "lin + bilateral rows")
    for nv, seed in ((64, 9), (100, 10)):
      wpb = gc.block_shape(48, nv, ("cone",) * 48, 32)[0]
      check_kernel(torch, random_problem(torch, 257, 48, seed=seed, nv=nv), (),
                   f"nc=48 nv={nv}, {wpb} world(s) a block of {wpb * _build.MF_LANES} threads")
    anymal_err = max(anymal_err, check_k2_tails(torch, list(args), cfg.row_kinds,
                                                "ANYmal factors"))
    # one world's rows past a block's shared memory: the device-memory layout
    wpb, _, layout = gc.block_shape(100, 304, ("cone",) * 100, 32)
    if layout != "device":
      fail(f"K2 took the {layout} layout at nc=100 nv=304, whose rows pass 227 KB")
    check_kernel(torch, random_problem(torch, 67, 100, seed=11), (),
                 f"nc=100 nv=304, the device layout, {wpb} world(s) a block")
    n0 = gc.solve_dynamics_batch.launches
    try:
      gc.solve_dynamics_batch(*random_problem(torch, 2, 4200, seed=12, nv=8), ct.SolverConfig())
      fail("K2 launched nc=4200 nv=8, whose small arrays do not fit a block")
    except ValueError as e:
      if gc.solve_dynamics_batch.launches != n0:
        fail("K2 counted a launch it refused")
      note(f"  nc=4200 nv=8 refused: {e}")

  # ---- 3. K2 rollouts ------------------------------------------------------
  B, H = 16384, 50
  note(f"phase 3: Scene.step_batch (K2) rollouts, B={B}, H={H}")
  with torch.inference_mode():
    s0, pd, q0 = standing_states(torch, scene, B, seed=2)
    _, _, counts = rollouts(torch, lambda st, p: scene.step_batch(st, pd_target=p),
                            s0, pd, H, gc, gs, "K2")
  if counts != (H, 0):
    fail(f"K2 rollouts launched (K2, K1) {counts} times for {H} steps")
  launches_roll = counts[0]

  # ---- 4. K2 MPPI -------------------------------------------------------------
  note("phase 4: MPPI through the K2 path")
  t_mppi, counts, steps = run_mppi(torch, scene, q0, "never", gc, gs)
  if counts != (steps, 0):
    fail(f"K2 MPPI launched (K2, K1) {counts} times for {steps} steps")
  launches_mppi = counts[0]

  # ---- 5. K2 golden replay -----------------------------------------------------
  note("phase 5: golden replay (tests/goldens/anymal_balance.npz) through step_batch")
  golden_replay(torch, lambda sc: lambda st, p: sc.step_batch(st, pd_target=p), "K2")

  # ---- 6. K2 times at the main path's shapes ----------------------------------
  note(f"phase 6: K2 times at B={B} (the rollouts), 2048 (the MPPI batch) and 384, "
       f"nc={len(kinds_any)}, nv={scene.model.nv}")
  k2_times = {}
  with torch.inference_mode():
    for b, seed in ((B, 2), (2048, 6), (384, 8)):
      sb, pdb = (s0, pd) if b == B else standing_states(torch, scene, b, seed=seed)[:2]
      args, cfg = pipeline.solver_inputs(scene, sb, torch.zeros_like(pdb), pdb)
      ins, rows_t = gc.kernel_inputs(*args, cfg)
      nbytes, nops = gc.mf_solve_cost(b, len(kinds_any), scene.model.nv, cfg.row_kinds,
                                      cfg.sweeps, cfg.n_grid)
      t_bytes = nbytes / H100_BYTES_PER_S * 1e3
      t_ops = nops / H100_F32_OPS_PER_S * 1e3
      k2_times[b] = dict(
          ms=time_cuda(torch, lambda: gc.solve_dynamics_batch(*args, cfg), 20),
          kernel_only_ms=time_cuda(torch, lambda: gc.launch_kernel(ins, rows_t, cfg), 20),
          plain_ms=time_cuda(torch, lambda: gc._mf_plain(*args, cfg), 3 if b == B else 2),
          bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")
      x = k2_times[b]
      note(f"  B={b}: wrapper {x['ms']:.3f} ms (kernel alone {x['kernel_only_ms']:.3f} ms), "
           f"plain twin {x['plain_ms']:.3f} ms; bound {x['bound_ms']:.4f} ms "
           f"({nbytes / 1e6:.1f} MB -> {t_bytes:.4f} ms, {nops / 1e9:.3f} GFLOP -> "
           f"{t_ops:.4f} ms)")
    step_ms = time_cuda(torch, lambda: scene.step_batch(s0, pd_target=pd), 5)
  wpb, smem, _ = gc.block_shape(len(kinds_any), scene.model.nv, cfg.row_kinds, cfg.n_grid)
  k2_ptxas = dict(_build.ptxas_figures("mf_solve"), smem_block_bytes=smem,
                  worlds_per_block=wpb, lanes=_build.MF_LANES)
  note(f"  whole K2-path step {step_ms:.3f} ms at B={B}; K2 build: {k2_ptxas}")
  k2 = {
      "name": "mf_solve (K2, cone_solve_lanes K3 inlined)",
      "route": "cuda",
      "source": "raisimlib_torch/csrc/mf_solve.cu",
      "body": "raisimlib_torch/csrc/mf_solve.cuh",
      "replaces": "raisimlib_tpu/ops/pallas_contact.py:164",
      "launches": launches_roll + launches_mppi,
      "launches_rollouts": launches_roll,
      "launches_mppi": launches_mppi,
      "max_abs_err": anymal_err,
      **k2_times[B],
      "library_ms": None,
      **{f"{k}_b{b}": v for b in k2_times if b != B for k, v in k2_times[b].items()},
      "step_ms": step_ms,
      "ptxas": k2_ptxas,
  }

  # ---- 7. K1 vs its plain twin, and vs the K2 path ----------------------------
  note("phase 7: K1 vs plain twin (float32), and vs the K2 path")
  with torch.inference_mode():
    s, pd7, _ = standing_states(torch, scene, 4096, seed=5)
    tau7 = torch.zeros_like(pd7)
    err_a, _ = check_fused(torch, fused, s, tau7, pd7, "perturbed standing states")
    check_against_k2(torch, scene, fused, s, tau7, pd7, "K1 vs K2 path, standing")
    for _ in range(20):
      s = fused(s, tau7, pd7)
    err_b, _ = check_fused(torch, fused, s, tau7, pd7, "20 steps into a rollout")
    check_against_k2(torch, scene, fused, s, tau7, pd7, "K1 vs K2 path, 20 steps in")
    err_c = check_tails(torch, fused, s, tau7, pd7, "20 steps in")
  k1_err = max(err_a, err_b, err_c)

  # ---- 8. K1 rollouts ----------------------------------------------------------
  note(f"phase 8: make_step_batch_fused (K1) rollouts, B={B}, H={H}")
  with torch.inference_mode():
    zero_tau = torch.zeros_like(pd)
    _, t_roll1, counts = rollouts(torch, lambda st, p: fused(st, zero_tau, p),
                                  s0, pd, H, gc, gs, "K1")
  if counts != (0, H):
    fail(f"K1 rollouts launched (K2, K1) {counts} times for {H} steps")
  k1_launches_roll = counts[1]

  # ---- 9. K1 MPPI --------------------------------------------------------------
  note("phase 9: MPPI through K1")
  t_mppi1, counts, steps = run_mppi(torch, scene, q0, "require", gc, gs)
  if counts != (0, steps):
    fail(f"K1 MPPI launched (K2, K1) {counts} times for {steps} steps")
  k1_launches_mppi = counts[1]

  # ---- 10. K1 golden replay ------------------------------------------------------
  note("phase 10: golden replay through K1")

  def fused_for(sc):
    step = gs.make_step_batch_fused(sc)
    return lambda st, p: step(st, torch.zeros_like(p), p)

  golden_replay(torch, fused_for, "K1")

  # ---- 11. K1 times ----------------------------------------------------------------
  note(f"phase 11: K1 times at B={B}, 2048 (the MPPI batch), 1024 and 384")
  lib = _build.load(kern.name)
  stream = torch.cuda.current_stream().cuda_stream
  k1_times = {}
  with torch.inference_mode():
    for b, seed in ((B, 2), (2048, 6), (1024, 7), (384, 8)):
      sb, pdb, _ = standing_states(torch, scene, b, seed=seed)
      taub = torch.zeros_like(pdb)
      qo, uo = torch.empty_like(sb.q), torch.empty_like(sb.u)
      ptrs = [x.data_ptr() for x in (sb.q, sb.u, taub, pdb)]
      outs = [qo.data_ptr(), uo.data_ptr()]
      k1_times[b] = (
          time_cuda(torch, lambda: fused(sb, taub, pdb), 20),
          time_cuda(torch, lambda: lib.fused_step_launch(*ptrs, None, 0, *outs, b, stream), 20))
    plain1_ms = time_cuda(torch, lambda: gs._fused_plain(fused.sd, s0.q, s0.u, zero_tau, pd), 2)
  ms1, kernel1_ms = k1_times[B]
  nbytes1, nops1 = gs.fused_step_cost(fused.sd, B, kern.ops_per_world)
  t_bytes1 = nbytes1 / H100_BYTES_PER_S * 1e3
  t_ops1 = nops1 / H100_F32_OPS_PER_S * 1e3
  dev_share = k1_launches_mppi * k1_times[2048][1] / 1e3 / t_mppi1
  note(f"  B={B}: wrapper {ms1:.3f} ms (kernel alone {kernel1_ms:.3f} ms), plain twin "
       f"{plain1_ms:.3f} ms; bound {max(t_bytes1, t_ops1):.4f} ms ({nbytes1 / 1e6:.1f} MB "
       f"-> {t_bytes1:.4f} ms, {nops1 / 1e9:.2f} GFLOP -> {t_ops1:.4f} ms)")
  note("  " + "; ".join(f"B={b}: wrapper {k1_times[b][0]:.3f} ms (kernel alone "
                       f"{k1_times[b][1]:.3f} ms)" for b in k1_times if b != B)
       + f"; MPPI through K1: kernel time {100 * dev_share:.1f}% of the wall time")
  note(f"  K1 source: {source_figures(gs, _build, kern)}")
  k1 = {
      "name": "fused_step (K1a, cone_solve K3 inlined)",
      "route": "cuda",
      "source": "raisimlib_torch/ops/gpu_step.py",
      "template": "raisimlib_torch/csrc/fused_step.cuh",
      "replaces": "raisimlib_tpu/ops/pallas_step.py:995",
      "launches": k1_launches_roll + k1_launches_mppi,
      "launches_rollouts": k1_launches_roll,
      "launches_mppi": k1_launches_mppi,
      "max_abs_err": k1_err,
      "ms": ms1,
      "kernel_only_ms": kernel1_ms,
      "plain_ms": plain1_ms,
      "bound_ms": max(t_bytes1, t_ops1),
      "bound_by": "bytes" if t_bytes1 >= t_ops1 else "operations",
      "library_ms": None,
      **{f"{k}_b{b}": k1_times[b][i] for b in k1_times if b != B
         for i, k in enumerate(("ms", "kernel_only_ms"))},
      "ops_per_world": kern.ops_per_world,
      "build_s": built.get(kern.name),
      "ptxas": source_figures(gs, _build, kern),
  }

  # ---- 12. terrain scene and K1c build ------------------------------------------------
  note("phase 12: terrain scene (ANYmal, 12 x 6 m heightmap, 48 x 24 samples) and K1c")
  with torch.inference_mode():
    hts64 = make_terrains(torch, 64)
  if not bool(torch.isfinite(hts64).all()):
    fail("terrain heights not finite")
  note(f"  64 terrains (seed 11, z_scale 0.06): heights in [{float(hts64.min()):.4f}, "
       f"{float(hts64.max()):.4f}] m")
  note(f"  K1c source: {kern_c.source.count(chr(10))} lines, {kern_c.ops_per_world} operations "
       f"and {kern_c.loads_per_world} height loads per world, "
       f"{len(fused_c.sd.slots)} hm_pt slots; nvcc {built.get(kern_c.name, 0.0):.2f} s")
  for line in _build.build_logs.get(kern_c.name, "").splitlines():
    if "registers" in line or "spill" in line:
      note(f"  ptxas[K1c]: {line.strip()}")

  # ---- 13. K1c vs its plain twin, and vs the K2 path ----------------------------------
  note("phase 13: K1c vs plain twin (float32), and vs the K2 path, one terrain per world")
  with torch.inference_mode():
    hts13 = hts64.repeat(4096 // 64, 1, 1)
    s, pd13, _ = terrain_states(torch, tscene, hts13, seed=13)
    tau13 = torch.zeros_like(pd13)
    errc_a, _ = check_fused(torch, fused_c, s, tau13, pd13, "terrain, perturbed standing states",
                            hts13)
    check_against_k2(torch, tscene, fused_c, s, tau13, pd13, "K1c vs K2 path, standing", hts13)
    for _ in range(20):
      s = fused_c(s, tau13, pd13, field_heights=hts13)
    errc_b, _ = check_fused(torch, fused_c, s, tau13, pd13, "terrain, 20 steps into a rollout",
                            hts13)
    check_against_k2(torch, tscene, fused_c, s, tau13, pd13, "K1c vs K2 path, 20 steps in", hts13)
    errc_c = check_tails(torch, fused_c, s, tau13, pd13, "terrain, 20 steps in", hts13)
  k1c_err = max(errc_a, errc_b, errc_c)

  # ---- 14. terrain rollouts through K1c -------------------------------------------------
  note(f"phase 14: terrain rollouts through K1c, B={B}, H={H}, 64 terrains tiled")
  with torch.inference_mode():
    hts14 = hts64.repeat(B // 64, 1, 1)
    s14, pd14, _ = terrain_states(torch, tscene, hts14, seed=14)
    tau14 = torch.zeros_like(pd14)
    _, t_roll_c, counts = rollouts(
        torch, lambda st, p: fused_c(st, tau14, p, field_heights=hts14), s14, pd14, H, gc, gs,
        "K1c")
  if counts != (0, H):
    fail(f"terrain rollouts launched (K2, K1) {counts} times for {H} steps")
  k1c_launches_roll = counts[1]
  note(f"  terrain rollouts/s {B / t_roll_c:.1f}")

  # ---- 15. trot MPPI through K1c ------------------------------------------------------------
  ticks = 150
  note("phase 15: trot MPPI (examples/anymal_trot_heightmap.py) through K1c")
  t_trot, counts, xf, trot_solves = run_trot(torch, ticks, gc, gs)
  if counts != (0, ticks * (16 * 8 + 8)):
    fail(f"trot MPPI launched (K2, K1) {counts} times for {ticks} ticks")
  k1c_launches_trot = counts[1]
  if not bool(torch.isfinite(xf).all()):
    fail("trot state not finite")
  z_end = xf[:, 2].cpu().numpy()
  note(f"  MPC solves/s {trot_solves:.2f} ({ticks} ticks in {t_trot:.2f} s)  launches K2 "
       f"{counts[0]} K1 {counts[1]}  forward distance {np.round(xf[:, 0].cpu().numpy(), 3).tolist()} m"
       f"  final base z {np.round(z_end, 3).tolist()} m")
  if not (z_end > 0.3).all():
    fail(f"a robot fell: final base z {z_end.tolist()}")

  # ---- 16. the trot golden through K1c and through the K2 path ------------------------
  note("phase 16: trot golden (tests/goldens/anymal_trot_heightmap.npz) through K1c and K2")

  def fused_trot(sc):
    step = gs.make_step_batch_fused(sc)
    return lambda st, p: step(st, torch.zeros_like(p), p)

  trot_dev_k1 = trot_golden(torch, fused_trot, "K1c")
  trot_dev_k2 = trot_golden(torch, lambda sc: lambda st, p: sc.step_batch(st, pd_target=p), "K2")

  # ---- 17. K1c times -----------------------------------------------------------------------
  note(f"phase 17: K1c times at B={B}, 2048, 1024 and 384 (the trot batch)")
  lib_c = _build.load(kern_c.name)
  k1c_times = {}
  with torch.inference_mode():
    for b, seed in ((B, 17), (2048, 19), (1024, 20), (384, 18)):
      hb = hts64.repeat((b + 63) // 64, 1, 1)[:b].contiguous()
      sb, pdb, _ = terrain_states(torch, tscene, hb, seed=seed)
      taub = torch.zeros_like(pdb)
      qo, uo = torch.empty_like(sb.q), torch.empty_like(sb.u)
      ptrs = [x.data_ptr() for x in (sb.q, sb.u, taub, pdb)]
      outs = [qo.data_ptr(), uo.data_ptr()]
      k1c_times[b] = (
          time_cuda(torch, lambda: fused_c(sb, taub, pdb, field_heights=hb), 20),
          time_cuda(torch, lambda: lib_c.fused_step_launch(
              *ptrs, hb.data_ptr(), hb.stride(0), *outs, b, stream), 20))
      if b == B:
        plain_c_ms = time_cuda(
            torch, lambda: gs._fused_plain(fused_c.sd, sb.q, sb.u, taub, pdb, hb), 2)
  msc, kernel_c_ms = k1c_times[B]
  nbytes_c, nops_c = gs.fused_step_cost(fused_c.sd, B, kern_c.ops_per_world,
                                        kern_c.loads_per_world)
  t_bytes_c = nbytes_c / H100_BYTES_PER_S * 1e3
  t_ops_c = nops_c / H100_F32_OPS_PER_S * 1e3
  note(f"  B={B}: wrapper {msc:.3f} ms (kernel alone {kernel_c_ms:.3f} ms), plain twin "
       f"{plain_c_ms:.3f} ms; bound {max(t_bytes_c, t_ops_c):.4f} ms ({nbytes_c / 1e6:.1f} MB "
       f"-> {t_bytes_c:.4f} ms, {nops_c / 1e9:.2f} GFLOP -> {t_ops_c:.4f} ms)")
  trot_share = k1c_launches_trot * k1c_times[384][1] / 1e3 / t_trot
  note("  " + "; ".join(f"B={b}: wrapper {k1c_times[b][0]:.3f} ms (kernel alone "
                       f"{k1c_times[b][1]:.3f} ms)" for b in k1c_times if b != B)
       + f"; trot MPPI: kernel time {100 * trot_share:.1f}% of the wall time")
  note(f"  K1c source: {source_figures(gs, _build, kern_c)}")
  k1c = {
      "name": "fused_step (K1c, hm_pt slots: heightmap probe + riser march; cone_solve K3 "
              "inlined)",
      "route": "cuda",
      "source": "raisimlib_torch/ops/gpu_step.py",
      "template": "raisimlib_torch/csrc/fused_step.cuh",
      "replaces": "raisimlib_tpu/ops/pallas_step.py:995",
      "launches": k1c_launches_roll + k1c_launches_trot,
      "launches_rollouts": k1c_launches_roll,
      "launches_trot_mppi": k1c_launches_trot,
      "max_abs_err": k1c_err,
      "ms": msc,
      "kernel_only_ms": kernel_c_ms,
      "plain_ms": plain_c_ms,
      "bound_ms": max(t_bytes_c, t_ops_c),
      "bound_by": "bytes" if t_bytes_c >= t_ops_c else "operations",
      "library_ms": None,
      **{f"{k}_b{b}": k1c_times[b][i] for b in k1c_times if b != B
         for i, k in enumerate(("ms", "kernel_only_ms"))},
      "ops_per_world": kern_c.ops_per_world,
      "height_loads_per_world": kern_c.loads_per_world,
      "build_s": built.get(kern_c.name),
      "ptxas": source_figures(gs, _build, kern_c),
      "trot_golden_max_dtau": {"K1c": trot_dev_k1, "K2": trot_dev_k2},
  }

  # ---- 18. K1b vs its plain twin, and vs the K2 path ---------------------------------------
  note("phase 18: K1b (ss, sb, sc slots) vs plain twin (float32), and vs the K2 path")
  kick = (3, STACK["kick_m_s"])
  k1b_errs = []
  with torch.inference_mode():
    s = loose_states(torch, sscene, 4096, seed=18, kick=kick)
    tau18 = torch.zeros_like(s.u)
    k1b_errs.append(check_k1b(torch, sscene, fused_b, s, tau18, "stack, start state", False))
    for _ in range(200):
      s = fused_b(s, tau18)
    z_box, z_sph = s.q[:, 2], s.q[:, 9]
    note(f"  after 200 steps: box z [{float(z_box.min()):.4f}, {float(z_box.max()):.4f}], "
         f"sphere z [{float(z_sph.min()):.4f}, {float(z_sph.max()):.4f}]")
    if float(z_sph.min()) < 0.40:
      fail("the sphere is not on the box 200 steps into the stack rollout")
    k1b_errs.append(check_k1b(torch, sscene, fused_b, s, tau18, "stack, 200 steps in"))
    k1b_errs.append(check_tails(torch, fused_b, s, tau18, None, "stack, 200 steps in"))
    for key, sc in k1b_scenes.items():
      st = k1b_steps[key]
      note(f"  {key}: slots {sorted(x.kind for x in st.sd.slots)}, body_b "
           f"{sorted({x.body_b for x in st.sd.slots if x.kind in K1B_KINDS})}")
      s = loose_states(torch, sc, 1037, seed=19, q0=CONTACT_Q[key])
      tau = torch.zeros_like(s.u)
      k1b_errs.append(check_k1b(torch, sc, st, s, tau, f"{key}, touching"))
      for _ in range(100):
        s = st(s, tau)
      k1b_errs.append(check_k1b(torch, sc, st, s, tau, f"{key}, 100 steps in", False))
  k1b_err = max(k1b_errs)

  # ---- 19. the stack golden through Scene.step, K1b and the K2 path ---------------------------
  note("phase 19: stack golden (tests/goldens/sphere_box_stack.npz, 400 steps) through "
       "Scene.step, K1b and the K2 path")
  stack_dev = {"Scene.step": stack_golden(torch, reference_step, "Scene.step")}

  def fused_stack(sc):
    step = gs.make_step_batch_fused(sc, use_pd=False)
    return lambda st: step(st, torch.zeros_like(st.u))

  stack_dev["K1b"] = stack_golden(torch, fused_stack, "K1b")
  stack_dev["K2"] = stack_golden(torch, lambda sc: lambda st: sc.step_batch(st), "K2")

  # ---- 20. examples/sphere_box_stack.py batched through K1b ---------------------------------
  n20 = int(round(STACK["sim_seconds"] / STACK["dt"]))
  note(f"phase 20: the stack example through K1b, {n20} steps ({STACK['sim_seconds']} s), "
       f"box kicked {STACK['kick_m_s']} m/s, noise on the positions and the box's velocity")
  for B20 in (16384, 4096):
    with torch.inference_mode():
      s20 = loose_states(torch, sscene, B20, seed=20, dq=STACK_DQ, du=STACK_DU, kick=kick)
      tau20 = torch.zeros_like(s20.u)
      t20, counts, _, gates = run_stack(torch, lambda st: fused_b(st, tau20), s20, n20, gc, gs)
    if t20 <= 60.0:
      break
    note(f"  {t20:.1f} s at B={B20}: over 60 s, so B=4096")
  k1b_launches = counts[1]
  stack_rate = B20 * n20 / t20
  note(f"  {t20:.2f} s, world-steps/s {stack_rate:.0f}, launches K2 {counts[0]} K1 {counts[1]}; "
       f"gates: {gates}")
  if counts != (0, n20):
    fail(f"the stack example launched (K2, K1) {counts} times for {n20} steps")
  if gates["worlds_failing"]:
    fail(f"{gates['worlds_failing']} of {B20} worlds miss the example's gates")
  # reported, not gated: phase 18's noise on every entry of q and u
  with torch.inference_mode():
    s = loose_states(torch, sscene, 4096, seed=20, kick=kick)
    tau = torch.zeros_like(s.u)
    _, _, _, gates_all = run_stack(torch, lambda st: fused_b(st, tau), s, n20, gc, gs)
  note(f"  with phase 18's noise on every q and u entry instead, B=4096: "
       f"{gates_all['worlds_failing']} worlds miss the gates (not a failure: see STACK_DQ); "
       f"{gates_all}")

  # ---- 21. K1b times -----------------------------------------------------------------------
  note(f"phase 21: K1b times at B={B}, 2048, 1024 and 384")
  lib_b = _build.load(kern_b.name)
  k1b_times = {}
  with torch.inference_mode():
    for b, seed in ((B, 21), (2048, 23), (1024, 22), (384, 24)):
      sb = loose_states(torch, sscene, b, seed=seed, kick=kick)
      taub = torch.zeros_like(sb.u)
      qo, uo = torch.empty_like(sb.q), torch.empty_like(sb.u)
      ptrs = [sb.q.data_ptr(), sb.u.data_ptr(), taub.data_ptr(), None]
      outs = [qo.data_ptr(), uo.data_ptr()]
      k1b_times[b] = (
          time_cuda(torch, lambda: fused_b(sb, taub), 20),
          time_cuda(torch, lambda: lib_b.fused_step_launch(*ptrs, None, 0, *outs, b, stream), 20))
      if b == B:
        plain_b_ms = time_cuda(torch, lambda: gs._fused_plain(fused_b.sd, sb.q, sb.u, taub), 2)
  msb, kernel_b_ms = k1b_times[B]
  nbytes_b, nops_b = gs.fused_step_cost(fused_b.sd, B, kern_b.ops_per_world)
  t_bytes_b = nbytes_b / H100_BYTES_PER_S * 1e3
  t_ops_b = nops_b / H100_F32_OPS_PER_S * 1e3
  note(f"  B={B}: wrapper {msb:.3f} ms (kernel alone {kernel_b_ms:.3f} ms), plain twin "
       f"{plain_b_ms:.3f} ms; bound {max(t_bytes_b, t_ops_b):.4f} ms ({nbytes_b / 1e6:.1f} MB "
       f"-> {t_bytes_b:.4f} ms, {nops_b / 1e9:.2f} GFLOP -> {t_ops_b:.4f} ms)")
  note("  " + "; ".join(f"B={b}: wrapper {k1b_times[b][0]:.3f} ms (kernel alone "
                       f"{k1b_times[b][1]:.3f} ms)" for b in k1b_times if b != B))
  note(f"  K1b source: {source_figures(gs, _build, kern_b)}")
  k1b = {
      "name": "fused_step (K1b, ss/sb/sc slots: sphere vs sphere, box, capsule; cone_solve K3 "
              "inlined)",
      "route": "cuda",
      "source": "raisimlib_torch/ops/gpu_step.py",
      "template": "raisimlib_torch/csrc/fused_step.cuh",
      "replaces": "raisimlib_tpu/ops/pallas_step.py:995",
      "launches": k1b_launches,
      "max_abs_err": k1b_err,
      "ms": msb,
      "kernel_only_ms": kernel_b_ms,
      "plain_ms": plain_b_ms,
      "bound_ms": max(t_bytes_b, t_ops_b),
      "bound_by": "bytes" if t_bytes_b >= t_ops_b else "operations",
      "library_ms": None,
      **{f"{k}_b{b}": k1b_times[b][i] for b in k1b_times if b != B
         for i, k in enumerate(("ms", "kernel_only_ms"))},
      "ops_per_world": kern_b.ops_per_world,
      "build_s": built.get(kern_b.name),
      "ptxas": source_figures(gs, _build, kern_b),
      "stack_worlds": B20,
      "stack_world_steps_per_s": stack_rate,
      "stack_golden_max_dq": stack_dev,
  }
  k1c_shapes = run_debris(torch, gs, gc, _build, built, debris, debris_steps, hts64, stream)
  k1_atlas, examples, ex_launches = run_entry_points(
      torch, gs, gc, _build, built, stream, (at_scene, at_q0, at_step), scen_steps, same_source)
  k1_ilqr, ilqr_rec = run_ilqr(torch, gs, gc, _build, built, stream, il_step)
  k2_scenes, k2_recs = run_k2_scenes(torch, gs, gc, card)
  par = run_parallel(torch, gs, gc, scene, s0, pd, H, t_roll1, il_step, card)
  k1["launches_sharded"] = par["sharded_rollout_K1"]["launches"][1]
  k1_ilqr["launches_sharded"] = (par["sharded_ilqr"]["launches"][1]
                                 + par["sharded_mppi"]["launches"][1])
  k1_atlas["launches_scaling"] = par["atlas_scaling"]["launches"][1]
  k2["launches_sharded"] = par["sharded_rollout_K2"]["launches"][0]
  k1["launches_balance_example"] = ex_launches["anymal_balance"]
  k1c["launches_trot_example"] = ex_launches["anymal_trot_heightmap"]
  k1b["launches_stack_example"] = ex_launches["sphere_box_stack"]

  note(f"  end to end: rollouts/s through K1 {B / t_roll1:.1f}; MPPI solves/s through "
       f"K2 {32 / t_mppi:.2f}, through K1 {32 / t_mppi1:.2f}; terrain rollouts/s through K1c "
       f"{B / t_roll_c:.1f}; trot MPC solves/s through K1c {trot_solves:.2f}; stack "
       f"world-steps/s through K1b {stack_rate:.0f}; debris world-steps/s through K1c "
       f"{ {n: round(x['world_steps_per_s']) for n, x in k1c_shapes['sources'].items()} }")
  ex_b, ex_t, ex_s, ex_a = (examples[n] for n in ("anymal_balance", "anymal_trot_heightmap",
                                                  "sphere_box_stack", "atlas_batch"))
  note(f"  the examples: balance MPC solves/s {ex_b['mpc_solves_per_s']:.2f} (final height "
       f"{ex_b['final_height']:.3f} m, passive {ex_b['passive_final_height']:.3f} m); trot MPC "
       f"solves/s {ex_t['mpc_solves_per_s']:.2f} (min forward {ex_t['min_forward_m']:.3f} m); "
       f"stack world-steps/s {ex_s['physics_steps'] / ex_s['wall_s']:.0f} (realtime factor "
       f"{ex_s['realtime_factor']:.2f}); Atlas rollouts/s {ex_a['rollouts_per_s']:.1f}, "
       f"world-steps/s {ex_a['steps_per_s']:.0f}, standing {ex_a['standing_fraction']:.4f}")
  il, cp = ilqr_rec["anymal_ilqr"], ilqr_rec["cartpole_swingup"]
  note(f"  iLQR: cartpole solve {cp['solve_s']:.2f} s (max|dU| {cp['max_abs_dU_golden']:.2e}); "
       f"ANYmal balance iLQR solves/s {il['fd_order_2']['solves_per_s']:.2f} (fd_order 2), "
       f"{il['fd_order_1']['solves_per_s']:.2f} (fd_order 1), {il['jvp']['solves_per_s']:.3f} "
       f"(exact, E={il['jvp']['n_env']}); mean cost ratios {il['fd_order_2']['cost_ratio']:.4f}, "
       f"{il['fd_order_1']['cost_ratio']:.4f}, {il['jvp']['cost_ratio']:.4f}")
  note("  K2 scenes: " + "; ".join(
      f"{n} {r['batch']} x {r['steps']} steps in {r['seconds']:.2f} s "
      f"({r['batch'] * r['steps'] / r['seconds']:.0f} world-steps/s)" for n, r in k2_recs.items()))
  note(f"  parallel (world size 1): sharded rollouts/s through K1 "
       f"{par['sharded_rollout_K1']['rollouts_per_s']:.1f} (unsharded "
       f"{par['unsharded_k1_rollouts_per_s']:.1f}), through K2 "
       f"{par['sharded_rollout_K2']['rollouts_per_s']:.1f}; sharded iLQR solves/s "
       f"{par['sharded_ilqr']['solves_per_s']:.2f}; sharded MPPI solves/s "
       f"{par['sharded_mppi']['solves_per_s']:.2f}")
  note(f"total {time.perf_counter() - t_start:.1f} s")
  note(f"card: {card}")
  print(json.dumps({"kernels": [k2, k1, k1c, k1b, k1c_shapes, k1_atlas, k1_ilqr] + k2_scenes}),
        flush=True)
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
  main()
