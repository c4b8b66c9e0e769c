"""The matrix-free solve (K2 with the cone solve K3 inside) against the JAX
package's Pallas kernel in interpret mode, f32.

On a CPU tensor the port's `solve_dynamics_batch` runs `_mf_plain`, the plain
PyTorch twin of the CUDA kernel: the same algorithm as the TPU kernel (hoisted
Gii, grid + two 5-point refinements + parabolic fit, wrap-around
neighbours), so the two agree to f32 round-off amplified by the Gauss-Seidel
sweeps. Tolerance: 3e-5 of the impulse scale on lam and u. Measured
(max over entries, relative to that scale): lam 8.6e-6 / 1.2e-5 / 5.0e-6 for
nc = 1 / 4 / 12, 6.1e-7 on the ANYmal layout, 4.6e-6 with lin + bilateral
rows; u at most 3.2e-6. The ANYmal-layout case and the CUDA kernel's own check
on the card are in tests/test_torch_gpu_contact_anymal.py and
tests/test_torch_cuda.py;
chip_smoke.py holds the kernel to `_mf_plain` at the main path's shapes."""

import jax
import numpy as np
import pytest
import torch


TOL = 3e-5


def _factor_problem(rng, B, nc, nv=None):
  nv = 3 * nc + 4 if nv is None else nv
  Jr = rng.standard_normal((B, nc, 3, nv))
  A = rng.standard_normal((B, nv, nv))
  M = A @ A.transpose(0, 2, 1) + 3.0 * np.eye(nv)
  Wt = np.einsum("bicv,bvw->bicw", Jr, np.linalg.inv(M))
  vf = rng.standard_normal((B, nv))
  bias = np.zeros((B, nc, 3))
  mu = rng.uniform(0.3, 1.2, (B, nc))
  active = (rng.uniform(size=(B, nc)) > 0.3).astype(np.float64)
  return [x.astype(np.float32) for x in (Jr, Wt, vf, bias, mu, active)]


def _compare(args, kinds):
  from raisimlib_tpu.ops import contact as jct
  from raisimlib_tpu.ops import pallas_contact as jpc
  from raisimlib_torch.ops import contact as tct
  from raisimlib_torch.ops import gpu_contact as tgc

  uj, lj = jax.jit(lambda *a: jpc.solve_dynamics_batch(
      *a, jct.SolverConfig(row_kinds=kinds)))(*args)
  launches = tgc.solve_dynamics_batch.launches
  ut, lt = tgc.solve_dynamics_batch(*[torch.tensor(a) for a in args],
                                    tct.SolverConfig(row_kinds=kinds))
  assert tgc.solve_dynamics_batch.launches == launches   # CPU: no kernel launch
  lj, uj = np.asarray(lj), np.asarray(uj)
  scale = np.abs(lj).max() + 1.0
  return (np.abs(lt.numpy() - lj) / scale, np.abs(ut.numpy() - uj) / scale)


@pytest.mark.parametrize("nc", [1, 4, 12])
def test_plain_twin_matches_tpu_kernel_random(nc):
  rng = np.random.default_rng(100 + nc)
  dl, du = _compare(_factor_problem(rng, 16, nc), ())
  assert dl.max() < TOL and du.max() < TOL, (dl.max(), du.max())


def test_plain_twin_bilateral_lin_and_ragged_batch():
  """A lin row (tangents zero, mu 0), a bilateral row (mu sentinel) and
  B = 37, which is not a multiple of any tile or block size."""
  rng = np.random.default_rng(5)
  Jr, Wt, vf, bias, mu, active = _factor_problem(rng, 37, 4)
  Jr[:, 1, :2] = 0.0
  Wt[:, 1, :2] = 0.0
  mu[:, 1] = 0.0
  mu[:, 3] = 1e7
  kinds = ("cone", "lin", "cone", "bilateral")
  dl, du = _compare([Jr, Wt, vf, bias, mu, active], kinds)
  assert dl.max() < TOL and du.max() < TOL, (dl.max(), du.max())
