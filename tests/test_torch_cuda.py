"""Tests that need the card: the hand-written CUDA kernels against their plain
PyTorch twins on the GPU. They skip without a CUDA device. JAX is not needed,
so on the GPU machine they run without the JAX test configuration:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance: the two-tier check of tests/test_pallas_contact.py (>= 99% of lam
entries within 1e-4 of the impulse scale, all within 3e-2): the kernel and its
twin run the same algorithm in float32 with different operation orders (FMA
contraction, reduction order), and a near-tie of the angular grid's argmin
can pick a neighbouring angle."""

import pytest
import torch

from torch_port_util import anymal_factors


@pytest.mark.cuda
def test_mf_solve_kernel_matches_plain_twin():
  """The CUDA kernel against `_mf_plain` on the card (chip_smoke.py runs the
  same check at the main path's shapes)."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device: the kernel has no CPU mode")
  from raisimlib_torch.ops import contact as tct
  from raisimlib_torch.ops import gpu_contact as tgc

  args, kinds = anymal_factors(1037)
  xs = [torch.tensor(a, device="cuda") for a in args]
  cfg = tct.SolverConfig(row_kinds=kinds)
  n0 = tgc.solve_dynamics_batch.launches
  uk, lk = tgc.solve_dynamics_batch(*xs, cfg)
  up, lp = tgc._mf_plain(*xs, cfg)
  torch.cuda.synchronize()
  assert tgc.solve_dynamics_batch.launches == n0 + 1
  scale = float(lp.abs().max()) + 1.0
  rel = ((lk - lp).abs() / scale).cpu().numpy()
  assert (rel < 1e-4).mean() >= 0.99 and rel.max() < 3e-2
