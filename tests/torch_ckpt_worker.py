"""Fault-injection worker of tests/test_torch_checkpoint.py: the port's
receding-horizon MPPI loop on the cartpole, checkpointed every iteration.

On launch it resumes from the latest checkpoint if one exists (what a
supervisor does after a worker dies), runs the MPPI updates with a
torch.Generator per iteration seeded from (SEED, i), so that the sequence of
updates is a function of the iteration index alone and the final plan is
bitwise the same whether or not the run was interrupted, and writes the
final plan to <workdir>/result.npy. The counterpart of tests/ckpt_worker.py.

Usage: python tests/torch_ckpt_worker.py <workdir> [--sleep SECONDS_PER_ITER]
"""

import argparse
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from raisimlib_torch.models import primitives  # noqa: E402
from raisimlib_torch.mpc.mppi import MPPIConfig, mppi_step  # noqa: E402
from raisimlib_torch.mpc.smooth import make_smooth_dyn  # noqa: E402
from raisimlib_torch.utils import checkpoint  # noqa: E402

N_ITERS = 6
H = 20
SEED = 7


def main():
  ap = argparse.ArgumentParser()
  ap.add_argument("workdir")
  ap.add_argument("--sleep", type=float, default=0.0)
  args = ap.parse_args()
  torch.set_num_threads(1)
  ckpt_path = os.path.join(args.workdir, "mppi.ckpt.npz")
  result_path = os.path.join(args.workdir, "result.npy")

  model = primitives.cartpole(dtype=torch.float64, device="cpu")
  dyn, nx, nu = make_smooth_dyn(model, (0.0, 0.0, -9.81), dt=0.05)

  def rc(X, U, t):
    return 0.1 * (X[:, 1] - math.pi) ** 2 + 0.01 * (U ** 2).sum(1)

  def fc(X):
    return 10.0 * (X[:, 1] - math.pi) ** 2 + 1.0 * X[:, 3] ** 2

  x0 = torch.zeros(nx, dtype=torch.float64)
  U = torch.zeros((H, nu), dtype=torch.float64)
  start = 0
  if checkpoint.latest(ckpt_path):
    U, scalars = checkpoint.restore(ckpt_path, U)
    start = int(scalars["iteration"]) + 1
    print(f"resumed from iteration {start - 1}", flush=True)

  cfg = MPPIConfig(n_samples=32, sigma=0.5, temperature=1.0)
  for i in range(start, N_ITERS):
    gen = torch.Generator().manual_seed(SEED * 1_000_003 + i)
    U = mppi_step(dyn, rc, fc, x0, U, gen, cfg).U
    checkpoint.save(ckpt_path, U, iteration=i)
    print(f"iteration {i} checkpointed", flush=True)
    if args.sleep:
      time.sleep(args.sleep)

  np.save(result_path, U.numpy())
  print("done", flush=True)


if __name__ == "__main__":
  main()
