"""BASELINE config 1: cartpole swing-up MPC (no contact), iLQR over the smooth
dynamics.

Counterpart of examples/cartpole_swingup.py. One iLQR solve (H = 50, 40
iterations; 10 with --smoke) from a small tilt; the converged plan is rolled
out and the pole must end upright. The costs are batched: (B, nx) states in,
(B,) costs out. The dynamics are make_smooth_dyn's ABA steps, plain PyTorch:
this example launches no kernel of the port. Reports the cost, the final
pole angle and the solve's seconds.

Run:  python3 -m raisimlib_torch.examples.cartpole_swingup [--smoke] [--device cpu]
"""

from __future__ import annotations

import os
import time

import torch

from raisimlib_torch.examples import METRICS_DIR, cli, gate, sync


def cartpole_costs(cw: dict, dt: float):
  """Batched running and final costs (rc(X, U, t) -> (B,), fc(X) -> (B,)) of
  the swing-up: the pole's height, the cart's offset, the velocities and
  the effort, weighted by the scenario's `run.cost`."""

  def rc(X, U, t):
    return (cw["upright"] * (torch.cos(X[:, 1]) + 1.0) + cw["cart"] * X[:, 0] ** 2
            + cw["vel"] * (X[:, 2] ** 2 + X[:, 3] ** 2)
            + cw["effort"] * torch.sum(U ** 2, 1)) * dt

  def fc(X):
    return (cw["final_upright"] * (torch.cos(X[:, 1]) + 1.0)
            + 2.0 * X[:, 0] ** 2 + X[:, 2] ** 2 + X[:, 3] ** 2)

  return rc, fc


def run(smoke: bool = False, device=None,
        metrics_path: str = os.path.join(METRICS_DIR, "cartpole_swingup.jsonl")) -> dict:
  """One warm-up solve, then the timed solve; the converged plan rolled out.
  A full-size run asserts that the pole ends upright. Returns the record,
  and beside it (not in the metrics file) the plan `U` as numpy."""
  from raisimlib_torch import scenarios
  from raisimlib_torch._device import resolve_device
  from raisimlib_torch.models import primitives
  from raisimlib_torch.mpc import ILQRConfig, ilqr, make_smooth_dyn
  from raisimlib_torch.utils import metrics

  dev = resolve_device(device)
  cfg = scenarios.load("cartpole_swingup")
  mc, cc, cw = cfg["model"], cfg["controller"], cfg["run"]["cost"]
  dtype = torch.float32
  model = primitives.cartpole(dtype=dtype, device=dev)
  dt = float(mc["dt"])
  dyn, nx, nu = make_smooth_dyn(model, [0.0, 0.0, -9.81], dt=dt, substeps=int(mc["substeps"]))
  rc, fc = cartpole_costs(cw, dt)

  H = int(cc["horizon"])
  iters = int(cc["smoke_iters"] if smoke else cc["iters"])
  x0 = torch.zeros(nx, dtype=dtype, device=dev)
  x0[1] = float(cfg["run"]["tilt0"])
  U0 = torch.zeros((H, nu), dtype=dtype, device=dev)
  config = ILQRConfig(iters=iters)

  t0 = time.perf_counter()
  ilqr(dyn, rc, fc, x0, U0, config)                    # warm-up
  sync(dev)
  compile_s = time.perf_counter() - t0                 # the warm-up solve (nothing compiles)
  t0 = time.perf_counter()
  sol = ilqr(dyn, rc, fc, x0, U0, config)
  sync(dev)
  solve_s = time.perf_counter() - t0

  # roll the converged plan; the pole must reach upright (theta -> pi)
  with torch.no_grad():
    x = x0[None]
    for t in range(H):
      x = dyn(x, sol.U[t:t + 1], t)
  theta_f = float(x[0, 1])
  result = {
      "cost": float(sol.cost),
      "final_theta": theta_f,
      "upright": abs(abs(theta_f) - 3.14159) < 0.5,
      "solve_s": solve_s,
      "compile_s": compile_s,
      "iters": iters,
      "horizon": H,
      "device": str(dev),
  }
  metrics.emit("example_cartpole_swingup", path=metrics_path, echo=True, **result)
  if not smoke:
    gate(result["upright"], f"swing-up failed: theta={theta_f}")
  return dict(result, U=sol.U.cpu().numpy())


if __name__ == "__main__":
  args = cli(__doc__.splitlines()[0]).parse_args()
  run(smoke=args.smoke, device=args.device)
