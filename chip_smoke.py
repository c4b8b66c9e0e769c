"""Smoke test of the PyTorch + CUDA port (raisimlib_torch) on one NVIDIA GPU.

Run from the repository root on a machine with an H100 and the CUDA toolkit:

    python3 chip_smoke.py

It builds the hand-written kernels (one nvcc per source, in parallel), then
drives the port's two main paths on the ANYmal balance configuration through
their public entry points:

  1. card and build: the card's name and power limit; the kernels' build
     (K2 from csrc/mf_solve.cu, K1 generated for the scene by
     ops/gpu_step.py), seconds and what ptxas says;
  K2 path (pipeline.step_batch, fused="never"):
  2. K2 against its plain twin on the card (float32): the ANYmal solver
     inputs at B = 4096, random problems with nc = 1, 4, 12, lin and
     bilateral rows, and B = 1037 (not a multiple of the block);
  3. rollouts: Scene.step_batch, B = 16384 worlds x H = 50 steps;
  4. MPPI: mppi_step_batch over make_contact_dyn_batch(fused="never"),
     16 envs x 128 samples, H = 50, 4 substeps, 2 updates;
  5. the f32 replay of tests/goldens/anymal_balance.npz through
     Scene.step_batch, held to the batched path's gate (utils/parity.py);
  6. K2 times at the main path's shapes;
  K1 path (the fused full step, ops/gpu_step.make_step_batch_fused):
  7. K1 against its plain twin on the card, B = 4096, from perturbed standing
     states and from a state 20 steps into a rollout (contacts active), and
     against the K2 path on the same inputs;
  8. rollouts through K1, B = 16384 x H = 50;
  9. MPPI through make_contact_dyn_batch(fused="require"), as phase 4;
  10. the golden replay through K1, under the same gate as phase 5;
  11. K1 times at B = 16384 (and B = 2048, the MPPI batch).

Both launch counters are set to 0 just before phases 3, 4, 8 and 9 and read
just after: each path must launch its own kernel once per physics step and
the other kernel never. Any failure exits non-zero. The last line of standard
output is one JSON object naming the device; the line before it holds the
kernels' numbers, and the line before that the card's name and power limit.
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


def anymal_scene(torch, dt=0.0025, kp=100.0, kd=2.0, device=None):
  from raisimlib_torch.models import anymal
  from raisimlib_torch.models.urdf import load_urdf
  from raisimlib_torch.world import World

  bodies, geoms, _ = load_urdf(anymal.anymal_urdf())
  world = World(dt=dt, dtype=torch.float32, device=device)   # None: the card
  world.add_articulated_system(bodies, name="anymal", geoms=geoms)
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


def random_problem(torch, B, nc, seed, kinds=()):
  g = torch.Generator(device="cuda").manual_seed(seed)
  f32 = dict(dtype=torch.float32, device="cuda", generator=g)
  nv = 3 * nc + 4
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


def check_kernel(torch, args, kinds, label):
  """K2 vs `_mf_plain` on the same inputs, with the two-tier check of
  tests/test_pallas_contact.py: >= 99% of lam entries within 1e-4 of the
  impulse scale, all within 3e-2, and the kernel's objective never worse by
  more than 2e-3 relative. Returns the max abs error over lam and u."""
  from raisimlib_torch.ops import contact as ct
  from raisimlib_torch.ops import gpu_contact as gc

  cfg = ct.SolverConfig(row_kinds=kinds)
  uk, lk = gc.solve_dynamics_batch(*args, cfg)
  up, lp = gc._mf_plain(*args, cfg)
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
  err = max(float((lk - lp).abs().max()), float((uk - up).abs().max()))
  note(f"  {label}: B={B} nc={nc} within 1e-4: {frac:.4f}, max rel {relmax:.2e}, "
       f"max abs err {err:.2e}, objective worse by at most {worse:.2e}")
  if frac < 0.99 or relmax >= 3e-2 or worse > 2e-3:
    fail(f"{label}: kernel disagrees with its plain twin")
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


def check_fused(torch, step, s, tau, pd, label):
  """K1 (through its wrapper) against `_fused_plain` on the same inputs;
  returns (max abs err, K1's state)."""
  from raisimlib_torch.ops import gpu_step as gs

  sk = step(s, tau, pd)
  qp, up = gs._fused_plain(step.sd, s.q, s.u, tau, pd)
  torch.cuda.synchronize()
  if not (torch.isfinite(sk.q).all() and torch.isfinite(sk.u).all()):
    fail(f"{label}: K1 output not finite")
  dq = (sk.q - qp).abs().amax(1)
  du = (sk.u - up).abs().amax(1)
  frac = float(((dq <= K1_TIGHT[0]) & (du <= K1_TIGHT[1])).float().mean())
  dq_max, du_max = float(dq.max()), float(du.max())
  note(f"  {label}: B={s.q.shape[0]} worlds within ({K1_TIGHT[0]:.0e} q, "
       f"{K1_TIGHT[1]:.0e} u): {frac:.4f}; max |dq| {dq_max:.2e}, max |du| {du_max:.2e}")
  if frac < 0.99 or dq_max > K1_CEILING[0] or du_max > K1_CEILING[1]:
    fail(f"{label}: K1 disagrees with its plain twin")
  return max(dq_max, du_max), sk


def check_against_k2(torch, scene, step, s, tau, pd, label):
  """K1 against the K2 path (Scene.step_batch) on the same inputs, at the
  kernel-vs-pure bounds of tests/test_torch_step.py (allclose: 5e-4 + 1e-4
  |ref| on q, 5e-3 + 1e-3 |ref| on u)."""
  s1 = step(s, tau, pd)
  s2 = scene.step_batch(s, tau, pd)
  torch.cuda.synchronize()
  over_q = float(((s1.q - s2.q).abs() - 5e-4 - 1e-4 * s2.q.abs()).max())
  over_u = float(((s1.u - s2.u).abs() - 5e-3 - 1e-3 * s2.u.abs()).max())
  note(f"  {label}: max |dq| {float((s1.q - s2.q).abs().max()):.2e}, "
       f"max |du| {float((s1.u - s2.u).abs().max()):.2e}")
  if over_q > 0.0 or over_u > 0.0:
    fail(f"{label}: K1 and the K2 path part beyond the kernel-vs-pure bounds")


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
  t0 = time.perf_counter()
  built = _build.build()
  note(f"build: {time.perf_counter() - t0:.2f} s in parallel; "
       + ", ".join(f"{n} {sec:.2f} s" for n, sec in built.items()))
  for name, log in _build.build_logs.items():
    for line in log.splitlines():
      if "registers" in line or "spill" in line or "error" in line:
        note(f"  ptxas[{name}]: {line.strip()}")

  # ---- 2. K2 vs plain twin ---------------------------------------------------
  note("phase 2: K2 vs plain twin (float32)")
  kinds_any = pipeline.scene_row_kinds(scene)
  s, pd, q0 = standing_states(torch, scene, 4096, seed=1)
  with torch.inference_mode():
    args, cfg = pipeline.solver_inputs(scene, s, torch.zeros_like(pd), pd)
    anymal_err = check_kernel(torch, list(args), cfg.row_kinds, "ANYmal factors")
    for nc in (1, 4, 12):
      check_kernel(torch, random_problem(torch, 1037, nc, seed=nc), (), f"random nc={nc}")
    kinds = ("cone", "lin", "cone", "bilateral")
    check_kernel(torch, random_problem(torch, 1037, 4, seed=7, kinds=kinds), kinds,
                 "lin + bilateral rows")

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
  note(f"phase 6: K2 times at B={B}, nc={len(kinds_any)}, nv={scene.model.nv}")
  with torch.inference_mode():
    args, cfg = pipeline.solver_inputs(scene, s0, torch.zeros_like(pd), pd)
    ins, kinds_t = gc.kernel_inputs(*args, cfg)
    ms = time_cuda(torch, lambda: gc.solve_dynamics_batch(*args, cfg), 20)
    kernel_ms = time_cuda(torch, lambda: gc.launch_kernel(ins, kinds_t, cfg), 20)
    plain_ms = time_cuda(torch, lambda: gc._mf_plain(*args, cfg), 3)
    step_ms = time_cuda(torch, lambda: scene.step_batch(s0, pd_target=pd), 5)
  nbytes, nops = gc.mf_solve_cost(B, len(kinds_any), scene.model.nv, cfg.row_kinds,
                                  ct.SolverConfig().sweeps, ct.SolverConfig().n_grid)
  t_bytes = nbytes / H100_BYTES_PER_S * 1e3
  t_ops = nops / H100_F32_OPS_PER_S * 1e3
  note(f"  wrapper {ms:.3f} ms (kernel alone {kernel_ms:.3f} ms), plain twin "
       f"{plain_ms:.3f} ms, whole step {step_ms:.3f} ms; bound {max(t_bytes, t_ops):.4f} ms "
       f"({nbytes / 1e6:.1f} MB -> {t_bytes:.4f} ms, {nops / 1e9:.2f} GFLOP -> {t_ops:.4f} ms)")
  k2 = {
      "name": "mf_solve (K2, cone_solve K3 inlined)",
      "route": "cuda",
      "source": "raisimlib_torch/csrc/mf_solve.cu",
      "replaces": "raisimlib_tpu/ops/pallas_contact.py:164",
      "launches": launches_roll + launches_mppi,
      "launches_rollouts": launches_roll,
      "launches_mppi": launches_mppi,
      "max_abs_err": anymal_err,
      "ms": ms,
      "kernel_only_ms": kernel_ms,
      "plain_ms": plain_ms,
      "bound_ms": max(t_bytes, t_ops),
      "bound_by": "bytes" if t_bytes >= t_ops else "operations",
      "library_ms": None,
      "step_ms": step_ms,
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
  k1_err = max(err_a, err_b)

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
  note(f"phase 11: K1 times at B={B} (and B=2048, the MPPI batch)")
  lib = _build.load(kern.name)
  stream = torch.cuda.current_stream().cuda_stream
  k1_times = {}
  with torch.inference_mode():
    for b, seed in ((B, 2), (2048, 6)):
      sb, pdb, _ = standing_states(torch, scene, b, seed=seed)
      taub = torch.zeros_like(pdb)
      qo, uo = torch.empty_like(sb.q), torch.empty_like(sb.u)
      ptrs = [x.data_ptr() for x in (sb.q, sb.u, taub, pdb, qo, uo)]
      k1_times[b] = (
          time_cuda(torch, lambda: fused(sb, taub, pdb), 20),
          time_cuda(torch, lambda: lib.fused_step_launch(*ptrs, b, stream), 20))
    plain1_ms = time_cuda(torch, lambda: gs._fused_plain(fused.sd, s0.q, s0.u, zero_tau, pd), 2)
  ms1, kernel1_ms = k1_times[B]
  nbytes1, nops1 = gs.fused_step_cost(fused.sd, B, kern.ops_per_world)
  t_bytes1 = nbytes1 / H100_BYTES_PER_S * 1e3
  t_ops1 = nops1 / H100_F32_OPS_PER_S * 1e3
  dev_share = k1_launches_mppi * k1_times[2048][1] / 1e3 / t_mppi1
  note(f"  B={B}: wrapper {ms1:.3f} ms (kernel alone {kernel1_ms:.3f} ms), plain twin "
       f"{plain1_ms:.3f} ms; bound {max(t_bytes1, t_ops1):.4f} ms ({nbytes1 / 1e6:.1f} MB "
       f"-> {t_bytes1:.4f} ms, {nops1 / 1e9:.2f} GFLOP -> {t_ops1:.4f} ms)")
  note(f"  B=2048: wrapper {k1_times[2048][0]:.3f} ms (kernel alone "
       f"{k1_times[2048][1]:.3f} ms); MPPI through K1: kernel time {100 * dev_share:.1f}% "
       f"of the wall time")
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
      "ms_b2048": k1_times[2048][0],
      "kernel_only_ms_b2048": k1_times[2048][1],
      "ops_per_world": kern.ops_per_world,
      "build_s": built.get(kern.name),
  }
  note(f"  end to end: rollouts/s through K1 {B / t_roll1:.1f}; MPPI solves/s through "
       f"K2 {32 / t_mppi:.2f}, through K1 {32 / t_mppi1:.2f}")
  note(f"total {time.perf_counter() - t_start:.1f} s")
  note(f"card: {card}")
  print(json.dumps({"kernels": [k2, k1]}), flush=True)
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
  main()
