"""Smoke test of the PyTorch + CUDA port (raisimlib_torch) on one NVIDIA GPU.

Run from the repository root on a machine with an H100 and the CUDA toolkit:

    python3 chip_smoke.py

It builds the hand-written kernels from csrc/, then drives the port's main
path — the ANYmal balance configuration — through its public entry points:

  1. card and build: the card's name and power limit, the kernels' build;
  2. each kernel against its plain PyTorch twin on the card (float32): the
     ANYmal solver inputs at B = 4096, random problems with nc = 1, 4, 12,
     lin and bilateral rows, and B = 1037 (not a multiple of the block);
  3. rollouts: Scene.step_batch, B = 16384 worlds x H = 50 steps;
  4. MPPI: mppi_step_batch, 16 envs x 128 samples, H = 50, 4 substeps,
     2 updates;
  5. the f32 replay of tests/goldens/anymal_balance.npz through
     Scene.step_batch, held to the batched path's gate (utils/parity.py);
  6. kernel times at the main path's shapes.

The launch counters are set to 0 just before phases 3 and 4 and read just
after; each must show the kernel launched once per physics step. Any failure
exits non-zero. The last line of standard output is one JSON object naming the
device; the line before it holds the kernels' numbers.
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


def anymal_scene(torch, dt=0.0025, kp=100.0, kd=2.0):
  from raisimlib_torch.models import anymal
  from raisimlib_torch.models.urdf import load_urdf
  from raisimlib_torch.world import World

  bodies, geoms, _ = load_urdf(anymal.anymal_urdf())
  world = World(dt=dt, dtype=torch.float32)          # device: the card
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
  f32 = dict(dtype=torch.float32, device="cuda")
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
  """Kernel vs `_mf_plain` on the same inputs, with the two-tier check of
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


def main():
  import torch

  if not torch.cuda.is_available():
    fail("torch.cuda.is_available() is false: this smoke test needs a CUDA device")
  try:
    from raisimlib_torch import _build
    from raisimlib_torch.mpc import mppi, state_map
    from raisimlib_torch.ops import gpu_contact as gc
    from raisimlib_torch.ops import pipeline
    from raisimlib_torch.ops.spatial import quat_box_minus
    from raisimlib_torch.utils import parity
  except ImportError as e:
    fail(f"cannot import the port (run from the repository root): {e}")
  t_start = time.perf_counter()

  # ---- 1. card and build ------------------------------------------------
  smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True, text=True,
                       timeout=60)
  card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"
  note(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
  t0 = time.perf_counter()
  built = _build.build()
  note(f"build: {time.perf_counter() - t0:.2f} s for {sorted(built) or 'nothing'}")
  for name, log in _build.build_logs.items():
    for line in log.splitlines():
      if "registers" in line or "spill" in line or "error" in line:
        note(f"  ptxas[{name}]: {line.strip()}")

  # ---- 2. kernel vs plain twin ---------------------------------------------
  note("phase 2: kernel vs plain twin (float32)")
  scene = anymal_scene(torch)
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

  # ---- 3. rollouts ---------------------------------------------------------
  B, H = 16384, 50
  note(f"phase 3: Scene.step_batch rollouts, B={B}, H={H}")
  with torch.inference_mode():
    s, pd, q0 = standing_states(torch, scene, B, seed=2)
    s0 = s
    scene.step_batch(s, pd_target=pd)                  # warm-up (allocator, cuBLAS)
    torch.cuda.synchronize()
    gc.solve_dynamics_batch.launches = 0
    t0 = time.perf_counter()
    for _ in range(H):
      s = scene.step_batch(s, pd_target=pd)
    torch.cuda.synchronize()
    t_roll = time.perf_counter() - t0
    launches_roll = gc.solve_dynamics_batch.launches
  if launches_roll != H:
    fail(f"rollouts launched the kernel {launches_roll} times for {H} steps")
  z = s.q[:, 2]
  if not (torch.isfinite(s.q).all() and torch.isfinite(s.u).all()):
    fail("rollout state not finite")
  z_lo, z_hi = float(z.min()), float(z.max())
  if z_lo < 0.35 or z_hi > 0.75:
    fail(f"base height left the band [0.35, 0.75]: [{z_lo:.3f}, {z_hi:.3f}]")
  note(f"  rollouts/s {B / t_roll:.1f}  ms/step {1e3 * t_roll / H:.2f}  "
       f"launches {launches_roll}  base z [{z_lo:.3f}, {z_hi:.3f}]")

  # ---- 4. MPPI ---------------------------------------------------------------
  E, K, HM, sub, updates = 16, 128, 50, 4, 2
  note(f"phase 4: mppi_step_batch, {E} envs x {K} samples, H={HM}, {sub} substeps, "
       f"{updates} updates")
  dyn_b, nx, nu = state_map.make_contact_dyn_batch(scene, control_dt=0.01, substeps=sub)
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
    gc.solve_dynamics_batch.launches = 0
    t0 = time.perf_counter()
    for _ in range(updates):
      sol = mppi.mppi_step_batch(dyn_b, rc, fc, x0s, Us, gen, cfg_m)
      Us = sol.U
    torch.cuda.synchronize()
    t_mppi = time.perf_counter() - t0
    launches_mppi = gc.solve_dynamics_batch.launches
  if launches_mppi != updates * HM * sub:
    fail(f"MPPI launched the kernel {launches_mppi} times for {updates * HM * sub} steps")
  if not (torch.isfinite(sol.cost).all() and torch.isfinite(Us).all()):
    fail("MPPI costs or plans not finite")
  note(f"  MPPI solves/s {E * updates / t_mppi:.2f}  physics steps/s "
       f"{E * K * HM * sub * updates / t_mppi:.0f}  launches {launches_mppi}  "
       f"cost of plan [{float(sol.cost.min()):.4f}, {float(sol.cost.max()):.4f}]")

  # ---- 5. golden replay ----------------------------------------------------
  note("phase 5: golden replay (tests/goldens/anymal_balance.npz) through step_batch")
  here = os.path.dirname(os.path.abspath(__file__))
  g = np.load(os.path.join(here, "tests", "goldens", "anymal_balance.npz"))
  gscene = anymal_scene(torch, kp=float(g["kp"]), kd=float(g["kd"]))
  f32 = dict(dtype=torch.float32, device="cuda")
  gs = gscene.init_state(q=torch.tensor(g["q0"][None], **f32),
                         u=torch.tensor(g["u0"][None], **f32))
  qs, us = [], []
  with torch.inference_mode():
    for tgt in g["pd_targets"]:
      gs = gscene.step_batch(gs, pd_target=torch.tensor(tgt[None], **f32))
      qs.append(gs.q[0].cpu().numpy())
      us.append(gs.u[0].cpu().numpy())
  dtau, dq = parity.golden_deviation(np.stack(qs), np.stack(us), g)
  k = parity.BATCH_TIGHT_STEPS
  note(f"  first {k} steps: max|dtau| {dtau[:k].max():.3e} N m, max|dq| {dq[:k].max():.3e}; "
       f"all {len(dtau)}: max|dtau| {dtau.max():.3e} N m, max|dq| {dq.max():.3e}")
  failures = parity.batch_gate_failures(np.stack(qs), np.stack(us), g)
  if failures:
    fail("golden gate: " + "; ".join(failures))

  # ---- 6. kernel times at the main path's shapes ----------------------------
  note(f"phase 6: kernel times at B={B}, nc={len(kinds_any)}, nv={scene.model.nv}")
  from raisimlib_torch.ops import contact as ct

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
  kernels = [{
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
  }]
  note(f"card: {card}")
  note(f"total {time.perf_counter() - t_start:.1f} s")
  print(json.dumps({"kernels": kernels}), flush=True)
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
  main()
