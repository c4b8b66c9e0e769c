"""The closed MPPI loop: E environments' controllers, each tick one update.

A tick draws the MPPI noise (E, K, H, nu) from the seed, calls the system's
`mppi_step_batch` over `make_contact_dyn_batch(fused="require")` with the
example's costs, and reads every environment's first action to the host,
as a controller that sends it to its robot must: the tick's latency runs
from its start, the state on the card, to that read. The plant then steps
each environment by the same dynamics, the host waits for its new state
(the robot's next measurement), and the next tick begins: no tick's latency
holds the plant's work, while the window's rate does. Every
`episode_ticks` ticks an episode ends and the next starts: for "balance",
the stance with a lateral push of `push` m/s whose sign is drawn from the
seed; for "trot", `envs` fresh terrains from the seed, each robot standing
on its surface, and the plan around the gait reference.

The comparison, on `check_ticks` ticks: the last of the window and the rest
drawn from the seed among its first `check_span` (only those are kept, so
that the check adds no allocations to the window): (a) each
dynamics call of the tick (the H sample-rollout steps and the plant's),
for `check_rows` of its rows drawn from the seed, replayed from the state
it was given by `substeps` reference steps (float64), compared by
portbench.compare.gaps; (b) the tick's plan update, recomputed by the
reference from the same noise and the reference's costs of the sampled
trajectories as the system rolled them out: the largest gap of the new
plan (`plan_gap`).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import inputs
from portbench.compare import gaps
from portbench.reference import mpc as rmpc
from portbench.reference.collide import Field
from portbench.reference.step import Scene as RefScene


class Cell:

  def __init__(self, cfg, p, seed, device, spans, substitute=None):
    from raisimlib_torch import scenarios
    from raisimlib_torch.mpc.mppi import MPPIConfig, mppi_step_batch
    from raisimlib_torch.mpc.state_map import make_contact_dyn_batch
    from raisimlib_torch.ops import gpu_step

    self.cfg, self.p, self.spans, self.dev = cfg, p, spans, device
    f32 = torch.float32
    self.E, self.K, self.H = int(p["envs"]), int(p["samples"]), int(p["horizon"])
    self.substeps, self.cdt = int(p["substeps"]), float(p["control_dt"])
    self.gen = torch.Generator(device=device).manual_seed(int(seed))
    self.host = torch.Generator().manual_seed(int(seed))
    self.check_at = set(torch.randperm(int(p["check_span"]), generator=self.host)
                        [:int(p["check_ticks"]) - 1].tolist())
    scene, _ = scenarios.build_scene({"world": cfg["world"]}, dtype=f32, device=device)
    spans.mark("scene")
    self.mcfg = MPPIConfig(n_samples=self.K, sigma=float(p["sigma"]),
                           temperature=float(p["temperature"]), smooth=float(p["smooth"]))
    self.launches = gpu_step.make_step_batch_fused
    self.dyn, nx, self.nu = make_contact_dyn_batch(scene, self.cdt, self.substeps,
                                                   use_pd=True, fused="require")
    self.mppi = mppi_step_batch
    if substitute is not None:
      self.dyn, self.mppi = substitute(scene, self)
    self.kernel_name = None
    if device.type == "cuda" and substitute is None:
      from raisimlib_torch import _build

      self.kernel_name = gpu_step.make_step_batch_fused(scene).kernel.name
      self.built = _build.build([self.kernel_name])
    spans.mark("kernel")
    q0 = inputs.stance(f32, device)
    self.q0, self.nx = q0, nx
    self.trot = p["task"] == "trot"
    if self.trot:
      from raisimlib_torch.examples.anymal_trot_heightmap import gait_reference, trot_costs

      ground = next(o for o in cfg["world"]["objects"] if o["type"] == "heightmap")
      self.size, self.samples = tuple(ground["size"]), tuple(ground["samples"])
      self.rc, self.fc = trot_costs(scene.field, float(q0[2]), float(p["v_target"]), self.cdt)
      self.gait = gait_reference(int(p["episode_ticks"]) + self.H, self.cdt,
                                 freq=float(p["gait_hz"]), swing=float(p["swing"]),
                                 dtype=f32, device=device)
    else:
      from raisimlib_torch.examples.anymal_balance import balance_costs

      self.rc, self.fc = balance_costs(p["cost"], float(q0[2]), q0[7:], self.cdt)
    self.rec = None
    spans.mark("costs")
    self._episode()
    self._tick(record=False)                                  # warm-up: the cell's shapes
    self._episode()
    self._sync()
    spans.mark("warm-up")

  def _sync(self):
    if self.dev.type == "cuda":
      torch.cuda.synchronize(self.dev)

  def _dyn(self, X, A, t, *ctx):
    with self.spans("dyn_b", B=X.shape[0], launches=self.substeps):
      out = self.dyn(X, A, t, *ctx)
    if self.rec is not None:
      self.rec.append((X, A, out))
    return out

  def _episode(self):
    """A new episode: fresh start states (and terrains), a fresh plan."""
    E, f32 = self.E, torch.float32
    with self.spans("draw"):
      x = torch.cat([self.q0[None].repeat(E, 1),
                     torch.zeros((E, self.nx - self.q0.numel()), dtype=f32, device=self.dev)], 1)
      if self.trot:
        self.hts = inputs.terrains(E, self.cfg["terrain"], self.size, self.samples, self.gen,
                                   f32, self.dev)
        x[:, 2] += inputs.ground_height(self.hts, self.size, x[:, :2])
        self.ctx = (self.hts,)
        self.U = torch.zeros((E, self.H, self.nu), dtype=f32, device=self.dev)  # offsets
      else:
        sign = 2.0 * (torch.rand((E,), generator=self.gen, device=self.dev) < 0.5).to(f32) - 1.0
        x[:, self.q0.numel() + 4] = float(self.p["push"]) * sign
        self.ctx = ()
        self.U = self.q0[7:].expand(E, self.H, self.nu).clone()
    self.x, self.m = x, 0

  def _tick(self, record: bool):
    """One controller update; returns its latency (s), the host's copy of
    the first actions and, when `record`, what the comparison reads."""
    E, K, H = self.E, self.K, self.H
    t0 = time.perf_counter()
    with self.spans("tick"):
      with self.spans("draw"):
        eps = self.mcfg.sigma * torch.randn((E, K, H, self.nu), generator=self.gen,
                                            dtype=torch.float32, device=self.dev)
      base = self.gait[self.m:self.m + H][None] if self.trot else None
      U = base + self.U if self.trot else self.U
      self.rec = [] if record else None
      with self.spans("mppi"):
        sol = self.mppi(self._dyn, self.rc, self.fc, self.x, U, config=self.mcfg,
                        eps_white=eps, env_ctx=self.ctx[0] if self.ctx else None)
      with self.spans("read"):
        a0 = sol.U[:, 0].to("cpu")
      lat = time.perf_counter() - t0
      with self.spans("plant"):
        x2 = self._dyn(self.x, sol.U[:, 0], 0, *self.ctx)
        self._sync()
    rec = dict(U=U, eps=eps, ctx=self.ctx, U_new=sol.U, calls=self.rec) if record else None
    self.rec = None
    if self.trot:
      self.U = torch.cat([sol.U[:, 1:] - base[:, 1:], sol.U[:, -1:] - base[:, -1:]], 1)
    else:
      self.U = torch.cat([sol.U[:, 1:], sol.U[:, -1:]], 1)
    self.x, self.m = x2, self.m + 1
    return lat, a0, rec

  def window(self, seconds: float) -> dict:
    self.kept, lats, bad = [], [], 0
    k0 = self.launches.launches
    per_episode = int(self.p["episode_ticks"])
    t0 = time.perf_counter()
    while True:
      if self.m == per_episode:
        self._episode()
      lat, a0, rec = self._tick(record=True)
      if len(lats) in self.check_at:
        self.kept.append(rec)
      lats.append(lat)
      bad += int((~torch.isfinite(a0).all(1)).sum())
      if time.perf_counter() - t0 >= seconds:
        break
    self._sync()
    t = time.perf_counter() - t0
    if len(lats) - 1 not in self.check_at:
      self.kept.append(rec)
    self.n_launches = self.launches.launches - k0
    self.lats, self.window_s = np.asarray(lats), t
    self.attempted, self.failed = self.E * len(lats), bad
    return {"mpc_solves_per_s": self.E * len(lats) / t,
            "mpc_update_p95_ms": float(np.percentile(self.lats, 95)) * 1e3}

  def notes(self):
    n, calls = len(self.lats), self.H + 1
    out = [f"mpc: {n} ticks of {self.E} x {self.K} samples, H {self.H} x {self.substeps} "
           f"substeps, in {self.window_s!r} s; latency median "
           f"{float(np.median(self.lats)) * 1e3!r} ms, p95 "
           f"{float(np.percentile(self.lats, 95)) * 1e3!r} ms; K1 launches in the window "
           f"{self.n_launches} (expected {n * calls * self.substeps}, {calls} calls a tick)"]
    if self.kernel_name is not None:
      from raisimlib_torch import _build

      out.append(f"kernel {self.kernel_name}: built here {self.built}, ptxas "
                 f"{_build.ptxas_figures(self.kernel_name)}")
    return out

  def release(self):
    """Drop the system's objects; keep the checked ticks."""
    self.checked, self.kept = self.kept, None
    self.dyn = self.mppi = self.x = self.U = None
    if self.dev.type == "cuda":
      torch.cuda.empty_cache()

  def compare(self, limits: dict):
    d, p = torch.float64, self.p
    ref = RefScene(self.cfg["world"], d, self.dev)
    EK, R = self.E * self.K, int(p["check_rows"])
    if self.trot:
      def field_of(h):
        return Field(h, torch.zeros(2, dtype=d, device=self.dev), self.size)

      rc, fc = rmpc.trot_costs(float(p["v_target"]), self.cdt, field_of)
    else:
      rc, fc = rmpc.balance_costs(p["cost"], self.cdt)
    plan_gap, xs, As, outs, hs = 0.0, [], [], [], []
    for tk in self.checked:
      calls = tk["calls"]                              # H rollout calls, then the plant's
      hts = tk["ctx"][0].to(d) if tk["ctx"] else None
      rows_h = None if hts is None else hts.repeat_interleave(self.K, 0)
      X = [c[0].to(d) for c in calls[:-1]] + [calls[-2][2].to(d)]
      ctx = () if hts is None else (rows_h,)
      cost = sum(rc(X[t], calls[t][1].to(d), *ctx) for t in range(self.H)) + fc(X[-1], *ctx)
      U_ref = rmpc.update(tk["U"].to(d), tk["eps"].to(d), cost.reshape(self.E, self.K),
                          self.mcfg.smooth, self.mcfg.temperature)
      plan_gap = max(plan_gap, float((tk["U_new"].to(d) - U_ref).abs().max()))
      rows = torch.randperm(EK, generator=self.host)[:R].to(self.dev)
      for Xi, A, Xo in calls[:-1]:
        xs.append(Xi[rows]), As.append(A[rows]), outs.append(Xo[rows])
        if hts is not None:
          hs.append(rows_h[rows])
      xs.append(calls[-1][0]), As.append(calls[-1][1]), outs.append(calls[-1][2])
      if hts is not None:
        hs.append(hts)
    X, A, Xo = (torch.cat(v).to(d) for v in (xs, As, outs))
    nq = ref.model.nq
    q, u = X[:, :nq], X[:, nq:]
    pd = torch.zeros_like(u)
    pd[:, 6:] = A
    H = torch.cat(hs).to(d) if hs else None
    margin = torch.full((q.shape[0],), float("inf"), dtype=d, device=self.dev)
    for _ in range(self.substeps):
      q, u, m = ref.step_margin(q, u, pd, H)
      margin = torch.minimum(margin, m)
    return gaps(Xo[:, :nq] - q, Xo[:, nq:] - u, margin, limits) + [
        ("plan_gap", plan_gap, limits["plan_gap"])]
