"""The port's examples, one per BASELINE config that the port covers:

    python3 -m raisimlib_torch.examples.sphere_box_stack [--smoke] [--device cpu]
    python3 -m raisimlib_torch.examples.anymal_balance [--smoke] [--device cpu]
    python3 -m raisimlib_torch.examples.anymal_trot_heightmap [--smoke] [--device cpu]
    python3 -m raisimlib_torch.examples.atlas_batch [--smoke] [--device cpu]
    python3 -m raisimlib_torch.examples.cartpole_swingup [--smoke] [--device cpu]
    python3 -m raisimlib_torch.examples.replay metrics/torch/anymal_balance_traj.npz

Each reads its scenario (raisimlib_torch/scenarios/*.json), runs on the card
unless asked for the CPU (where the kernels' plain twins stand in), builds
every kernel before its timed loop (the cartpole runs none: its dynamics are
plain PyTorch), asserts its physics gates on a full-size
run and appends its record to metrics/torch/<name>.jsonl. `run()` takes the
same settings as keyword arguments.
"""

from __future__ import annotations

import argparse
import os

import torch

METRICS_DIR = os.path.join("metrics", "torch")


def gate(ok: bool, msg: str) -> None:
  """A physics gate of a full-size run: raises AssertionError when it fails."""
  if not ok:
    raise AssertionError(msg)


def sync(dev: torch.device) -> None:
  if dev.type == "cuda":
    torch.cuda.synchronize(dev)


def build_kernels(dev: torch.device) -> None:
  """Build every kernel registered so far (one nvcc each, in parallel) on
  the card, so that no build falls inside a timed loop."""
  if dev.type == "cuda":
    from raisimlib_torch import _build

    _build.build()


def cli(description: str) -> argparse.ArgumentParser:
  ap = argparse.ArgumentParser(description=description)
  ap.add_argument("--smoke", action="store_true", help="the scenario's smoke sizes")
  ap.add_argument("--device", default=None, help="cuda (default) or cpu")
  return ap
