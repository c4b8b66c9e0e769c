"""Device resolution and the float32 matmul-precision guard.

The card is the default device: an entry point given no device runs on CUDA,
and raises where there is none instead of carrying on silently on the CPU.
Tests and CPU users pass `device="cpu"` explicitly.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
  """`None` means the card; a missing card is an error, never a CPU fallback."""
  if device is None:
    if not torch.cuda.is_available():
      raise RuntimeError(
          "raisimlib_torch runs on a CUDA device by default and none is "
          "available; pass device='cpu' to run on the CPU explicitly")
    return torch.device("cuda")
  return torch.device(device)


def check_matmul_precision() -> None:
  """Refuse reduced-precision float32 matmuls instead of overriding them.

  A reduced-precision product zeroed a small rotational inertia term in the
  world-frame mass-matrix congruence (a difference of large parallel-axis
  terms), which made M singular and the step NaN. TF32 keeps about three
  decimal digits, so the physics needs full float32 products. The port does
  not clobber a process-wide choice; it raises and names the flag."""
  if torch.backends.cuda.matmul.allow_tf32:
    raise RuntimeError(
        "torch.backends.cuda.matmul.allow_tf32 is True: TF32 matmuls lose the "
        "small inertia terms of the mass matrix (singular M, NaN steps); set "
        "it to False")
  prec = torch.get_float32_matmul_precision()
  if prec != "highest":
    raise RuntimeError(
        f"torch.get_float32_matmul_precision() is {prec!r}: reduced-precision "
        "float32 matmuls lose the small inertia terms of the mass matrix "
        "(singular M, NaN steps); call "
        "torch.set_float32_matmul_precision('highest')")
