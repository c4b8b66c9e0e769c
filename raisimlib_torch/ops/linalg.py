"""Column-unrolled dense linear algebra for small batched SPD systems.

Counterpart of raisimlib_tpu/ops/linalg.py, with the same recurrences and the
same `eps` clamp on the pivots, so that the CPU parity tests against the JAX
package hold at f64 round-off (a library factorization would pivot and sum in
another order). All functions take (..., n, n) / (..., n, m) and batch over
the leading axes.
"""

from __future__ import annotations

import torch


def chol(A: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
  """Lower Cholesky factor of an SPD matrix, unrolled over columns."""
  n = A.shape[-1]
  below = [torch.arange(n, device=A.device) >= j for j in range(n)]
  cols = []
  for j in range(n):
    s = A[..., :, j]
    for k in range(j):
      s = s - cols[k] * cols[k][..., j:j + 1]
    d = torch.sqrt(torch.clamp(s[..., j:j + 1], min=eps))
    cols.append(torch.where(below[j], s / d, torch.zeros_like(s)))
  return torch.stack(cols, -1)


def solve_lower(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
  """X with L X = B (L lower-triangular), forward substitution unrolled."""
  n = L.shape[-1]
  rows = []
  for i in range(n):
    r = B[..., i, :]
    for k in range(i):
      r = r - L[..., i, k:k + 1] * rows[k]
    rows.append(r / L[..., i, i:i + 1])
  return torch.stack(rows, -2)


def solve_lower_t(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
  """X with L^T X = B, backward substitution unrolled."""
  n = L.shape[-1]
  rows = [None] * n
  for i in range(n - 1, -1, -1):
    r = B[..., i, :]
    for k in range(i + 1, n):
      r = r - L[..., k, i:i + 1] * rows[k]
    rows[i] = r / L[..., i, i:i + 1]
  return torch.stack(rows, -2)


def cho_solve(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
  """Solve A X = B given A's lower Cholesky factor L."""
  return solve_lower_t(L, solve_lower(L, B))


def spd_solve(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
  """Solve SPD A X = B end to end (unrolled chol + substitutions)."""
  return cho_solve(chol(A), B)
