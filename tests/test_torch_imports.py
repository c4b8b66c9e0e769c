"""The port stands alone: raisimlib_torch imports no jax, flax or raisimlib_tpu,
and its entry points default to the CUDA device."""

import ast
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "flax", "raisimlib_tpu")


def test_import_loads_no_jax():
  code = ("import sys, raisimlib_torch, raisimlib_torch.convert, "
          "raisimlib_torch.mpc.mppi, raisimlib_torch.mpc.state_map, "
          "raisimlib_torch.ops.pipeline\n"
          f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
          "print(bad); sys.exit(1 if bad else 0)")
  env = dict(os.environ, PYTHONPATH=REPO)
  r = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                     capture_output=True, text=True, timeout=120)
  assert r.returncode == 0, r.stdout + r.stderr


def _imported_modules(path):
  tree = ast.parse(open(path).read(), path)
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      yield from (a.name for a in node.names)
    elif isinstance(node, ast.ImportFrom) and node.module:
      yield node.module


@pytest.mark.parametrize("name", ["raisimlib_torch", "chip_smoke.py"])
def test_no_forbidden_import_in_source(name):
  root = os.path.join(REPO, name)
  files = ([root] if root.endswith(".py") else
           [os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs
            if f.endswith(".py")])
  assert files
  bad = [(f, m) for f in files for m in _imported_modules(f)
         if m.split(".")[0] in FORBIDDEN]
  assert not bad, bad


def test_world_defaults_to_cuda():
  from raisimlib_torch.world import World

  if torch.cuda.is_available():
    assert World().device.type == "cuda"
  else:
    with pytest.raises(RuntimeError, match="device='cpu'"):
      World()
  assert World(device="cpu").device.type == "cpu"
