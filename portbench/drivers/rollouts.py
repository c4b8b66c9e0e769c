"""Batched open-loop rollouts through the fused step (K1), one batch in flight.

Each batch draws `worlds` start states (the stance with N(0, q_noise) on q)
and per-step, per-world PD targets (the stance's joint angles plus
N(0, target_sigma)), then calls the system's `make_step_batch_fused(scene)`
once a physics step for `horizon` steps. On a terrain configuration
`terrains` fractal fields are drawn at set-up and tiled one per world, and
each world starts on its terrain's surface. The window ends with the batch
that completes past its length.

The comparison takes the states of a batch drawn from the seed among the
first `check_first` and of the last batch, for `check_worlds` worlds drawn
from the seed, and steps each of their states once with the reference
(portbench.compare.gaps says what is compared).
"""

from __future__ import annotations

import time

import torch

from portbench import inputs
from portbench.compare import gaps
from portbench.reference.step import Scene as RefScene


class Cell:

  def __init__(self, cfg, p, seed, device, spans, substitute=None):
    from raisimlib_torch import scenarios
    from raisimlib_torch.ops import gpu_step
    from raisimlib_torch.ops.integrator import State

    self.State, self.spans, self.dev = State, spans, device
    self.cfg, self.p = cfg, p
    self.B, self.H = int(p["worlds"]), int(p["horizon"])
    f32 = torch.float32
    self.gen = torch.Generator(device=device).manual_seed(int(seed))
    host = torch.Generator().manual_seed(int(seed))
    scene, _ = scenarios.build_scene({"world": cfg["world"]}, dtype=f32, device=device)
    spans.mark("scene")
    self.kernel_name = None
    if substitute is None:
      step = gpu_step.make_step_batch_fused(scene)
      self.launches = gpu_step.make_step_batch_fused
      if device.type == "cuda":
        from raisimlib_torch import _build

        self.kernel_name = step.kernel.name
        self.built = _build.build([self.kernel_name])
    else:
      step = substitute(scene)
      self.launches = None
    self.step = step
    spans.mark("kernel")
    self.hts, self.size = None, None
    ground = next(o for o in cfg["world"]["objects"] if o["type"] == "heightmap") \
        if cfg.get("terrain") else None
    if ground is not None:
      self.size = tuple(ground["size"])
      fields = inputs.terrains(int(p["terrains"]), cfg["terrain"], self.size,
                               tuple(ground["samples"]), self.gen, f32, device)
      tile = torch.arange(self.B, device=device) % fields.shape[0]
      self.hts = fields[tile].contiguous()
    self.tau = torch.zeros((self.B, scene.model.nv), dtype=f32, device=device)
    self.check_rows = torch.randperm(self.B, generator=host)[:int(p["check_worlds"])]
    self.check_first = int(torch.randint(int(p["check_first"]), (1,), generator=host))
    spans.mark("inputs")
    self._batch(keep=False)                                   # warm-up: the cell's shapes
    self._sync()
    spans.mark("warm-up")

  def _sync(self):
    if self.dev.type == "cuda":
      torch.cuda.synchronize(self.dev)

  def _batch(self, keep: bool):
    """One rollout batch; its states (entering each step and the last) when
    `keep`, and its count of worlds that ended non-finite."""
    p, B = self.p, self.B
    with self.spans("draw"):
      q, u = inputs.standing_states(B, p["q_noise"], self.gen, torch.float32, self.dev)
      if self.hts is not None:
        q[:, 2] += inputs.ground_height(self.hts, self.size, q[:, :2])
      pd = inputs.pd_targets(self.H, B, p["target_sigma"], self.gen, torch.float32, self.dev)
    s = self.State(q=q, u=u, t=torch.zeros(B, dtype=torch.float32, device=self.dev))
    traj = [s]
    for t in range(self.H):
      with self.spans("step", B=B, launches=1):
        s = self.step(s, self.tau, pd[t], field_heights=self.hts)
      if keep:
        traj.append(s)
    bad = (~torch.isfinite(torch.cat([s.q, s.u], 1)).all(1)).sum()
    return (traj if keep else None), pd, bad

  def window(self, seconds: float) -> dict:
    self.kept, bads, n = [], [], 0
    k0 = self.launches.launches if self.launches is not None else 0
    t0 = time.perf_counter()
    while True:
      traj, pd, bad = self._batch(keep=True)
      self._sync()
      bads.append(bad)
      if n == self.check_first:
        self.kept.append((traj, pd))
      last = (traj, pd)
      n += 1
      t = time.perf_counter() - t0
      if t >= seconds:
        break
    if n - 1 != self.check_first:
      self.kept.append(last)
    self.n_launches = (self.launches.launches - k0) if self.launches is not None else None
    self.batches, self.window_s = n, t
    self.attempted = n * self.B
    self.failed = int(torch.stack(bads).sum())
    return {"world_steps_per_s": n * self.B * self.H / t}

  def notes(self):
    out = [f"rollouts: {self.batches} batches of {self.B} worlds x {self.H} steps in "
           f"{self.window_s!r} s; K1 launches in the window {self.n_launches} "
           f"(expected {self.batches * self.H})"]
    if self.kernel_name is not None:
      from raisimlib_torch import _build

      out.append(f"kernel {self.kernel_name}: built here {self.built}, ptxas "
                 f"{_build.ptxas_figures(self.kernel_name)}")
    return out

  def release(self):
    """Drop the system's objects; keep the checked states."""
    rows = self.check_rows.to(self.dev)
    self.checked = []
    for traj, pd in self.kept:
      q = torch.stack([s.q[rows] for s in traj])              # (H + 1, R, nq)
      u = torch.stack([s.u[rows] for s in traj])
      self.checked.append((q, u, pd[:, rows]))
    self.hts_rows = None if self.hts is None else self.hts[rows]
    self.kept = self.step = self.tau = None
    if self.dev.type == "cuda":
      torch.cuda.empty_cache()

  def compare(self, limits: dict):
    """One reference step (float64) from each checked state: the gaps of q'
    and u' against what the timed path produced."""
    ref = RefScene(self.cfg["world"], torch.float64, self.dev)
    qs, us, qn, un, pds, hts = [], [], [], [], [], []
    for q, u, pd in self.checked:
      H, R = pd.shape[:2]
      qs.append(q[:-1].reshape(H * R, -1))
      us.append(u[:-1].reshape(H * R, -1))
      qn.append(q[1:].reshape(H * R, -1))
      un.append(u[1:].reshape(H * R, -1))
      pds.append(pd.reshape(H * R, -1))
      if self.hts_rows is not None:
        hts.append(self.hts_rows.repeat(H, 1, 1))
    d = torch.float64
    q2, u2, margin = ref.step_margin(torch.cat(qs).to(d), torch.cat(us).to(d),
                                     torch.cat(pds).to(d), torch.cat(hts).to(d) if hts else None)
    return gaps(torch.cat(qn).to(d) - q2, torch.cat(un).to(d) - u2, margin, limits)
