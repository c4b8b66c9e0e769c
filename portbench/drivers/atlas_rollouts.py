"""Batched open-loop rollouts of the Atlas-class humanoid through the fused
step (K1 at nv = 29), one batch in flight: the `rollouts` driver with the
humanoid's inputs and reference.

Each batch draws `worlds` start states (the humanoid's stance with
N(0, q_noise) on q, the quaternion renormalised, zero velocity) and per-step,
per-world PD targets (the stance's joint angles plus N(0, target_sigma),
zero on the floating base). The window, the spans (`draw`, `step` with B
and launches) and the checked rows are the `rollouts` driver's; the float64
comparison steps the checked states with `reference.atlas.Scene`. The notes
add the window's K1 launches that took the wide build, and ptxas's figures
for both of the scene's K1 builds (from the run that built them).
"""

from __future__ import annotations

import json
import os

import torch

from portbench.compare import gaps
from portbench.drivers import rollouts
from portbench.reference import atlas
from portbench.run import PKG, load_json


def standing_states(q0, B: int, noise: float, gen):
  """(q (B, nq), u (B, nv)): q0 with N(0, noise) on every coordinate (the
  quaternion renormalised) and zero velocity."""
  q = q0 + noise * torch.randn((B, q0.numel()), generator=gen, dtype=q0.dtype, device=q0.device)
  q[:, 3:7] = q[:, 3:7] / q[:, 3:7].norm(dim=1, keepdim=True)
  return q, torch.zeros((B, q0.numel() - 1), dtype=q0.dtype, device=q0.device)


def pd_targets(q0, steps: int, B: int, sigma: float, gen):
  """(steps, B, nv) PD targets: q0's joint angles plus N(0, sigma), fresh per
  step and world; zero on the floating base."""
  nv = q0.numel() - 1
  pd = torch.zeros((steps, B, nv), dtype=q0.dtype, device=q0.device)
  pd[..., 6:] = q0[7:] + sigma * torch.randn((steps, B, nv - 6), generator=gen, dtype=q0.dtype,
                                             device=q0.device)
  return pd


def ptxas_figures(build, name: str) -> dict:
  """ptxas's figures for the kernel `name` (`build.ptxas_figures`): those of
  this process's build, kept in portbench/out/ptxas.json for the later runs
  in the checkout, which load the library without building it."""
  path = os.path.join(PKG, "out", "ptxas.json")
  known = load_json(path) if os.path.exists(path) else {}
  figures = build.ptxas_figures(name)
  if figures["registers"] is not None:
    known[name] = figures
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
      json.dump(known, f, indent=1)
  return known.get(name, figures)


class Cell(rollouts.Cell):

  def __init__(self, cfg, p, seed, device, spans, substitute=None):
    self.q0 = torch.as_tensor(atlas.standing_q(), dtype=torch.float32, device=device)
    super().__init__(cfg, p, seed, device, spans, substitute)

  def _batch(self, keep: bool):
    p, B = self.p, self.B
    with self.spans("draw"):
      q, u = standing_states(self.q0, B, p["q_noise"], self.gen)
      pd = pd_targets(self.q0, self.H, B, p["target_sigma"], self.gen)
    s = self.State(q=q, u=u, t=torch.zeros(B, dtype=torch.float32, device=self.dev))
    traj = [s]
    for t in range(self.H):
      with self.spans("step", B=B, launches=1):
        s = self.step(s, self.tau, pd[t])
      if keep:
        traj.append(s)
    bad = (~torch.isfinite(torch.cat([s.q, s.u], 1)).all(1)).sum()
    return (traj if keep else None), pd, bad

  def window(self, seconds: float) -> dict:
    w0 = self.launches.launches_wide if self.launches is not None else 0
    out = super().window(seconds)
    self.n_wide = (self.launches.launches_wide - w0) if self.launches is not None else None
    return out

  def notes(self):
    out = super().notes()
    out.append(f"K1 launches in the window that took the wide build: {self.n_wide}")
    if self.kernel_name is not None:
      from raisimlib_torch import _build

      for lanes, name in sorted(self.step.kernel.names.items()):
        out.append(f"{lanes}-lane build {name}: ptxas {ptxas_figures(_build, name)}")
    return out

  def compare(self, limits: dict):
    """One float64 step of the humanoid's reference from each checked state:
    the gaps of q' and u' against what the timed path produced."""
    ref = atlas.Scene(self.cfg["world"], torch.float64, self.dev)
    d = torch.float64
    qs, us, qn, un, pds = [], [], [], [], []
    for q, u, pd in self.checked:
      n = pd.shape[0] * pd.shape[1]
      qs.append(q[:-1].reshape(n, -1))
      us.append(u[:-1].reshape(n, -1))
      qn.append(q[1:].reshape(n, -1))
      un.append(u[1:].reshape(n, -1))
      pds.append(pd.reshape(n, -1))
    q2, u2, margin = ref.step_margin(torch.cat(qs).to(d), torch.cat(us).to(d),
                                     torch.cat(pds).to(d))
    return gaps(torch.cat(qn).to(d) - q2, torch.cat(un).to(d) - u2, margin, limits)
