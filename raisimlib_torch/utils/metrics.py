"""Structured metrics: one JSON object per line.

Counterpart of raisimlib_tpu/utils/metrics.py. Every example and benchmark
emits its results as records

  {"ts": <unix seconds>, "kind": "<record kind>", ...fields}

appended to a JSONL file and/or printed. Host-side code: a tensor field, on
the card too, becomes a Python number or list (one device-to-host copy).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Optional


def _jsonable(v: Any) -> Any:
  """Tensors, numpy arrays and scalars as plain Python for json.dumps."""
  if hasattr(v, "item") and getattr(v, "ndim", None) == 0:
    return v.item()
  if hasattr(v, "tolist"):
    return v.tolist()
  return v


def emit(kind: str, path: Optional[str] = None, echo: bool = False, **fields) -> dict:
  """Append one structured record; returns the record dict."""
  rec = {"ts": round(time.time(), 3), "kind": kind}
  rec.update({k: _jsonable(v) for k, v in fields.items()})
  line = json.dumps(rec)
  if path:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "a") as f:
      f.write(line + "\n")
  if echo or not path:
    print(line, flush=True)
  return rec


class MetricsLogger:
  """Bound emitter: a fixed output path and common fields (run id, config)."""

  def __init__(self, path: Optional[str] = None, echo: bool = False, **common):
    self.path = path
    self.echo = echo
    self.common = common

  def emit(self, kind: str, **fields) -> dict:
    return emit(kind, path=self.path, echo=self.echo, **{**self.common, **fields})

  def read_all(self) -> list:
    if not self.path or not os.path.exists(self.path):
      return []
    with open(self.path) as f:
      return [json.loads(line) for line in f if line.strip()]
