"""The matrix-free solve on the main path's own layout: the plain twin vs
the JAX package's Pallas kernel (interpret mode, f32) on real ANYmal solver
inputs (12 cone + 12 lin rows, nv = 18). Tolerance as in
tests/test_torch_gpu_contact.py (measured here: 6.1e-7 of the impulse scale
on lam, 2.1e-6 on u)."""

from test_torch_gpu_contact import TOL, _compare
from torch_port_util import anymal_factors
from torch_port_util import one_thread  # noqa: F401  (a module fixture)


def test_plain_twin_matches_tpu_kernel_anymal_layout():
  args, kinds = anymal_factors(8)
  assert kinds == ("cone",) * 12 + ("lin",) * 12
  dl, du = _compare(args, kinds)
  assert dl.max() < TOL and du.max() < TOL, (dl.max(), du.max())
