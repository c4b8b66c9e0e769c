"""A small pytree layer for the port's containers.

The JAX package flattens its states and carries with `jax.tree_util`. The
port's are dataclasses (State, the configs), NamedTuples (the solutions),
dicts, lists and tuples of tensors; these helpers walk them in the order and
with the leaf-path strings that `jax.tree_util.keystr` gives the JAX
package's counterparts: a dataclass or NamedTuple field `.q`, a dict entry
`['U']` (dict keys sorted), a sequence item `[0]`. `None` is an empty
subtree; anything else that is not a container is a leaf.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Tuple


def _is_namedtuple(x) -> bool:
  return isinstance(x, tuple) and hasattr(type(x), "_fields")


def _children(tree) -> List[Tuple[str, Any]]:
  """(key string, child) pairs of a container; [] for a leaf or None."""
  if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
    return [(f".{f.name}", getattr(tree, f.name)) for f in dataclasses.fields(tree)]
  if _is_namedtuple(tree):
    return [(f".{k}", v) for k, v in zip(tree._fields, tree)]
  if isinstance(tree, dict):
    return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
  if isinstance(tree, (list, tuple)):
    return [(f"[{i}]", v) for i, v in enumerate(tree)]
  return []


def is_leaf(tree) -> bool:
  return tree is not None and not (
      (dataclasses.is_dataclass(tree) and not isinstance(tree, type))
      or isinstance(tree, (dict, list, tuple)))


def flatten_with_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
  """[(path, leaf)] in depth-first order."""
  if tree is None:
    return []
  if is_leaf(tree):
    return [(prefix, tree)]
  out = []
  for key, child in _children(tree):
    out += flatten_with_paths(child, prefix + key)
  return out


def leaves(tree) -> list:
  return [x for _, x in flatten_with_paths(tree)]


def unflatten(template, new_leaves) -> Any:
  """`template` with its leaves replaced, in order, by `new_leaves`."""
  it = iter(new_leaves)

  def build(t):
    if t is None:
      return None
    if is_leaf(t):
      return next(it)
    if dataclasses.is_dataclass(t):
      return dataclasses.replace(t, **{f.name: build(getattr(t, f.name))
                                       for f in dataclasses.fields(t)})
    if _is_namedtuple(t):
      return type(t)(*(build(v) for v in t))
    if isinstance(t, dict):
      return {k: build(t[k]) for k in sorted(t)}
    return type(t)(build(v) for v in t)

  out = build(template)
  if next(it, it) is not it:
    raise ValueError("more leaves than the template holds")
  return out


def tree_map(fn: Callable, tree) -> Any:
  return unflatten(tree, [fn(x) for x in leaves(tree)])
