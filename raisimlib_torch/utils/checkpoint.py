"""Checkpoint and resume for simulation, solver and MPC state: the port's
counterpart of raisimlib_tpu/utils/checkpoint.py.

Every piece of run state (States, MPPI and iLQR carries, batched rollout
states) is a pytree of tensors (utils/tree.py), so a checkpoint is
structural: the leaves go to one `.npz` as `leaf_%05d`, their paths as
`__paths__` and keyword scalars as `scalar_<name>`, the format of the JAX
package, whose leaf paths are the ones `jax.tree_util.keystr` gives. So a
checkpoint that the JAX package wrote restores into the port's template,
and the reverse. `restore` takes a template with the same structure and
checks the leaf paths, shapes and dtypes against it, so that a topology
change fails loudly instead of resuming garbage; the tensors come back on
the template's devices.

Writes are atomic (a tmp file and os.replace): a worker killed mid-save
leaves the previous checkpoint intact.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from raisimlib_torch.utils import tree as tree_lib


def _to_numpy(x) -> np.ndarray:
  if isinstance(x, torch.Tensor):
    return x.detach().cpu().numpy()
  return np.asarray(x)


def save(path: str, tree: Any, **scalars) -> None:
  """Dump a pytree of tensors (and Python scalars, e.g. iteration=k)."""
  flat = tree_lib.flatten_with_paths(tree)
  arrays = {f"leaf_{i:05d}": _to_numpy(x) for i, (_, x) in enumerate(flat)}
  arrays["__paths__"] = np.asarray([p for p, _ in flat], dtype=object)
  for k, v in scalars.items():
    if k.startswith("leaf_") or k == "__paths__":
      raise ValueError(f"reserved checkpoint key {k!r}")
    arrays[f"scalar_{k}"] = np.asarray(v)
  os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
  tmp = path + ".tmp"
  with open(tmp, "wb") as f:
    np.savez(f, **arrays)
  os.replace(tmp, path)


def restore(path: str, template: Any) -> tuple:
  """Load `path` into the structure of `template` -> (tree, scalars dict).

  Checks the leaf paths, and each leaf's shape and dtype, against the
  template's; a mismatch raises ValueError."""
  with np.load(path, allow_pickle=True) as z:
    keys = sorted(k for k in z.files if k.startswith("leaf_"))
    loaded = [z[k] for k in keys]
    saved_paths = [str(p) for p in z["__paths__"]]
    scalars = {k[len("scalar_"):]: z[k][()] for k in z.files if k.startswith("scalar_")}

  flat = tree_lib.flatten_with_paths(template)
  t_paths = [p for p, _ in flat]
  if saved_paths != t_paths:
    raise ValueError(
        f"checkpoint structure mismatch: saved {len(saved_paths)} leaves "
        f"{saved_paths[:4]}..., template has {len(t_paths)} leaves {t_paths[:4]}...")
  leaves = []
  for p, a, (_, t) in zip(saved_paths, loaded, flat):
    tn = _to_numpy(t) if not isinstance(t, torch.Tensor) else None
    ts = tuple(t.shape) if tn is None else tn.shape
    td = (torch.empty((), dtype=t.dtype).numpy().dtype if tn is None else tn.dtype)
    if a.shape != ts or a.dtype != td:
      raise ValueError(f"checkpoint leaf {p}: saved shape/dtype {a.shape}/{a.dtype} vs "
                       f"template {ts}/{td}")
    leaves.append(torch.from_numpy(a).to(t.device) if tn is None else a)
  return tree_lib.unflatten(template, leaves), scalars


def latest(path: str) -> bool:
  """True if a complete checkpoint exists at `path`."""
  return os.path.exists(path)
