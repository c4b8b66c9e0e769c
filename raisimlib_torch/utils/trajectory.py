"""Trajectory recording and offline replay.

Counterpart of raisimlib_tpu/utils/trajectory.py. RaiSim streams poses over a
TCP socket to a viewer every frame (`RaisimServer`); here a rollout records on
the device, moves to the host once at the end, and lands in one `.npz` that
any offline tool can replay (`python3 -m raisimlib_torch.examples.replay`
renders it with matplotlib). The files are those of the JAX package.

File schema (float arrays):
  q         (T+1, nq)   generalized coordinates (row 0 = initial state)
  u         (T+1, nv)   generalized velocities
  t         (T+1,)      sim time
  body_pos  (T+1, nb, 3) world body origins (FK, precomputed for viewers)
  body_rot  (T+1, nb, 3, 3)
  con_pos   (T, nc, 3)  contact points          } step_with_report's
  con_nrm   (T, nc, 3)  contact normals         } observables; present
  con_imp   (T, nc, 3)  world-frame impulses    } iff with_contacts
  con_act   (T, nc)     contact validity mask   }
plus metadata: body names, dt.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from raisimlib_torch.ops import dynamics, pipeline
from raisimlib_torch.ops.integrator import State


def _fk_host(model, qs):
  """Body origins (T, nb, 3) and rotations (T, nb, 3, 3) of the rows of qs,
  FK batched over the rows, as numpy."""
  with torch.inference_mode():
    kin = dynamics.fk(model, torch.as_tensor(qs, dtype=model.dtype, device=model.device))
    return kin.p.cpu().numpy(), kin.R.cpu().numpy()


def record(scene, state0: State, n_steps: int, tau=None, pd_target=None,
           with_contacts: bool = True) -> dict:
  """Roll one world (state0.q (nq,)) `n_steps` steps and record everything:
  a dict of host numpy arrays (the schema above).

  tau / pd_target: None, a constant (nv,) vector, or an (n_steps, nv)
  schedule. The steps run as a Python loop of pipeline.step_with_report on
  a batch of one world; the records stack on the device and move to the
  host once at the end."""
  model = scene.model
  q0, u0 = state0.q, state0.u
  dtype, dev = q0.dtype, q0.device

  def sched(x):
    if x is None:
      return None
    x = torch.as_tensor(x, dtype=dtype, device=dev)
    if x.ndim == 1:
      return x.expand(n_steps, model.nv)
    if tuple(x.shape) != (n_steps, model.nv):
      raise ValueError(f"schedule has shape {tuple(x.shape)}, expected ({n_steps}, {model.nv})")
    return x

  taus, pds = sched(tau), sched(pd_target)
  zeros = torch.zeros((1, model.nv), dtype=dtype, device=dev)
  s = State(q=q0[None], u=u0[None], t=torch.as_tensor(state0.t, dtype=dtype, device=dev)[None])
  qs, us, ts, rep = [s.q[0]], [s.u[0]], [s.t[0]], []
  with torch.inference_mode():
    for k in range(n_steps):
      tau_k = zeros if taus is None else taus[k][None]
      pd_k = None if pds is None else pds[k][None]
      if with_contacts:
        s, con, _, lam_w = pipeline.step_with_report(scene, s, tau_k, pd_k)
        nc = con.pos.shape[1]
        rep.append((con.pos[0], con.normal[0], lam_w[0, :nc], con.active[0].to(dtype)))
      else:
        s = pipeline.step(scene, s, tau_k, pd_k)
      qs.append(s.q[0])
      us.append(s.u[0])
      ts.append(s.t[0])
    out = [torch.stack(x).cpu().numpy() for x in (qs, us, ts)]
    if with_contacts:
      out += [torch.stack(x).cpu().numpy() for x in zip(*rep)]
  body_pos, body_rot = _fk_host(model, out[0])
  traj = {
      "q": out[0], "u": out[1], "t": out[2],
      "body_pos": body_pos, "body_rot": body_rot,
      "dt": np.asarray(scene.dt),
      "body_names": np.asarray(list(model.body_names), dtype=object),
  }
  if with_contacts:
    traj.update(con_pos=out[3], con_nrm=out[4], con_imp=out[5], con_act=out[6])
  return traj


def from_states(scene, qs, us=None, dt: float | None = None) -> dict:
  """A replayable trajectory from recorded (T, nq) coordinates (numpy or
  tensors), for closed-loop examples that log states tick by tick (MPC
  loops) rather than through `record`. FK runs batched over the T rows."""
  model = scene.model
  qs = qs.detach().cpu().numpy() if torch.is_tensor(qs) else np.asarray(qs)
  T = qs.shape[0]
  if us is None:
    us = np.zeros((T, model.nv))
  else:
    us = us.detach().cpu().numpy() if torch.is_tensor(us) else np.asarray(us)
  dt = scene.dt if dt is None else dt
  body_pos, body_rot = _fk_host(model, qs)
  return {
      "q": qs, "u": us, "t": dt * np.arange(T),
      "body_pos": body_pos, "body_rot": body_rot,
      "dt": np.asarray(dt),
      "body_names": np.asarray(list(model.body_names), dtype=object),
  }


def save(path: str, traj: dict) -> None:
  os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
  np.savez_compressed(path, **traj, allow_pickle=True)


def load(path: str) -> dict:
  with np.load(path, allow_pickle=True) as z:
    return {k: z[k] for k in z.files if k != "allow_pickle"}


def render_matplotlib(traj: dict, out_png: str, stride: int = 10,
                      bodies: Optional[list] = None) -> None:
  """Offline replay: a 3-panel figure (XZ side view ghosted over time, body
  heights, contact impulse magnitudes) saved to PNG. Headless (Agg)."""
  import matplotlib

  matplotlib.use("Agg")
  import matplotlib.pyplot as plt

  bp = traj["body_pos"]                      # (T, nb, 3)
  t = traj["t"]
  T, nb, _ = bp.shape
  sel = list(range(nb)) if bodies is None else bodies

  fig, axes = plt.subplots(1, 3, figsize=(15, 4.2))
  ax = axes[0]
  frames = range(0, T, max(1, stride))
  for fi, k in enumerate(frames):
    alpha = 0.15 + 0.85 * fi / max(1, len(frames) - 1)
    ax.plot(bp[k, sel, 0], bp[k, sel, 2], ".", ms=3, alpha=alpha, color="C0")
  ax.set_xlabel("x [m]")
  ax.set_ylabel("z [m]")
  ax.set_title("side view (time-ghosted)")
  ax.axhline(0.0, color="k", lw=0.5)

  ax = axes[1]
  for b in sel[: min(len(sel), 8)]:
    ax.plot(t, bp[:, b, 2], lw=0.8)
  ax.set_xlabel("t [s]")
  ax.set_ylabel("body z [m]")
  ax.set_title("body heights")

  ax = axes[2]
  if "con_imp" in traj:
    imp = np.linalg.norm(traj["con_imp"], axis=-1) * traj["con_act"]  # (T, nc)
    ax.plot(t[1:], imp.sum(axis=1), lw=0.8, color="C3")
    ax.set_title("total contact impulse")
    ax.set_xlabel("t [s]")
    ax.set_ylabel("|impulse| [N s]")
  else:
    ax.set_axis_off()
  fig.tight_layout()
  fig.savefig(out_png, dpi=110)
  plt.close(fig)
