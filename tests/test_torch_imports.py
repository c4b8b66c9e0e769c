"""The port stands alone: raisimlib_torch (its scenarios, utilities and
examples included) imports no jax, flax or raisimlib_tpu, and its entry points
default to the CUDA device."""

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
          "raisimlib_torch.ops.pipeline, raisimlib_torch.ops.gpu_step, "
          "raisimlib_torch.ops.heightmap, raisimlib_torch.utils.terrain, "
          "raisimlib_torch.utils.parity, raisimlib_torch.scenarios, "
          "raisimlib_torch.utils.metrics, raisimlib_torch.utils.trajectory, "
          "raisimlib_torch.models.atlas, raisimlib_torch.examples.anymal_balance, "
          "raisimlib_torch.examples.anymal_trot_heightmap, "
          "raisimlib_torch.examples.atlas_batch, raisimlib_torch.examples.replay, "
          "raisimlib_torch.examples.sphere_box_stack, raisimlib_torch.examples.cartpole_swingup, "
          "raisimlib_torch.mpc, raisimlib_torch.mpc.ilqr, raisimlib_torch.mpc.smooth, "
          "raisimlib_torch.mpc.balance_ilqr, raisimlib_torch.models.primitives\n"
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


@pytest.mark.parametrize("factory", ["build_model", "build_geom_table"])
def test_table_factories_default_to_cuda(factory):
  """build_model and build_geom_table, called without a device, put their
  tables on the card (and raise without one), as World does."""
  import numpy as np

  from raisimlib_torch.models.model import JointType, build_model
  from raisimlib_torch.ops import collision as coll

  if factory == "build_model":
    bodies = [dict(parent=-1, joint=JointType.REVOLUTE, mass=1.0)]
    make = lambda **kw: build_model("arm", bodies, **kw).q_init   # noqa: E731
  else:
    specs = [coll.GeomSpec(0, coll.GEOM_SPHERE, np.array([0.1, 0, 0, 0]), np.zeros(3),
                           np.eye(3), 0)]
    make = lambda **kw: coll.build_geom_table(specs, **kw).params   # noqa: E731
  if torch.cuda.is_available():
    assert make().device.type == "cuda"
  else:
    with pytest.raises(RuntimeError, match="device='cpu'"):
      make()
  assert make(device="cpu").device.type == "cpu"


def test_terrain_defaults_to_cuda():
  """The terrain builders, called without a device, build on the card (and
  raise without one); World.add_heightmap moves the field to the world's
  device, so a World() scene's field lives on the card."""
  from raisimlib_torch.utils import terrain
  from raisimlib_torch.world import World

  props = terrain.TerrainProperties(x_samples=8, y_samples=6)
  if torch.cuda.is_available():
    assert terrain.flat().heights.device.type == "cuda"
    assert terrain.generate(props).heights.device.type == "cuda"
    world = World()
    world.add_heightmap(terrain.flat(device="cpu"))
    assert world.compile().field.heights.device.type == "cuda"
  else:
    for make in (terrain.flat, lambda: terrain.generate(props)):
      with pytest.raises(RuntimeError, match="device='cpu'"):
        make()
  world = World(device="cpu")
  world.add_heightmap(terrain.flat(device="cpu"))
  field = world.compile().field
  assert field.heights.device.type == "cpu" and field.center.device.type == "cpu"
