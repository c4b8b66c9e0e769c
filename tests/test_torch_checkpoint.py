"""The port's checkpoints (raisimlib_torch/utils/checkpoint.py) against the
JAX package's (tests/test_checkpoint.py):

  * a State and a nested carry round-trip bitwise, with their scalars;
  * restoring onto another topology (a shape, a structure) raises;
  * a checkpoint that the JAX package's `save` wrote restores bitwise into
    the port's template, and one that the port wrote restores bitwise into
    the JAX package's (the same npz layout and leaf paths);
  * kill and resume: tests/torch_ckpt_worker.py runs the port's cartpole
    MPPI loop, is SIGKILLed once two checkpoints have landed, and a
    restarted worker resumes and ends on the uninterrupted run's plan,
    bitwise.
"""

import os
import signal
import subprocess
import sys
import time
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import one_thread  # noqa: F401  (a module fixture)

from raisimlib_torch.utils import checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Carry(NamedTuple):
  U: object
  cost: object


def _port_state():
  from raisimlib_torch.models import primitives
  from raisimlib_torch.ops import integrator

  s = integrator.init_state(primitives.cartpole(dtype=torch.float64, device="cpu"))
  return integrator.State(q=s.q + torch.tensor([0.3, -1.7], dtype=torch.float64),
                          u=s.u + 0.25, t=s.t + 0.125)


def _port_tree():
  """A State, a dict with a tuple (an int64 scalar among its leaves) and a
  NamedTuple: every container kind the port's checkpoints carry."""
  return {"state": _port_state(),
          "U": torch.arange(12.0, dtype=torch.float64).reshape(3, 4),
          "aux": (torch.ones(2, dtype=torch.float32), torch.tensor(5, dtype=torch.int64)),
          "sol": Carry(U=torch.linspace(0, 1, 6, dtype=torch.float64).reshape(3, 2),
                       cost=torch.tensor(2.5, dtype=torch.float64))}


def _jax_tree():
  from raisimlib_tpu.ops.integrator import State

  t = _port_tree()
  s = t["state"]
  return {"state": State(q=jnp.asarray(s.q.numpy()), u=jnp.asarray(s.u.numpy()),
                         t=jnp.asarray(s.t.numpy())),
          "U": jnp.asarray(t["U"].numpy()),
          "aux": (jnp.ones(2, jnp.float32), jnp.asarray(5, jnp.int64)),
          "sol": Carry(U=jnp.asarray(t["sol"].U.numpy()), cost=jnp.asarray(2.5))}


def _zeros_like(tree):
  from raisimlib_torch.utils import tree as tree_lib

  return tree_lib.tree_map(torch.zeros_like, tree)


def _assert_bitwise(a, b):
  """The same leaf paths, dtypes, shapes and bits (a JAX tree or the port's:
  flax's State and the port's are both dataclasses)."""
  from raisimlib_torch.utils import tree as tree_lib

  fa, fb = tree_lib.flatten_with_paths(a), tree_lib.flatten_with_paths(b)
  assert [p for p, _ in fa] == [p for p, _ in fb]
  for (p, x), (_, y) in zip(fa, fb):
    x, y = np.asarray(x), np.asarray(y)
    assert x.dtype == y.dtype and x.shape == y.shape, p
    np.testing.assert_array_equal(x, y, err_msg=p)


def test_state_roundtrip(tmp_path):
  from raisimlib_torch.ops import integrator

  s = _port_state()
  p = str(tmp_path / "state.npz")
  checkpoint.save(p, s, iteration=3)
  s2, scalars = checkpoint.restore(p, _zeros_like(s))
  assert int(scalars["iteration"]) == 3 and isinstance(s2, integrator.State)
  _assert_bitwise(s2, s)
  assert not os.path.exists(p + ".tmp")


def test_nested_carry_roundtrip(tmp_path):
  tree = _port_tree()
  p = str(tmp_path / "carry.npz")
  checkpoint.save(p, tree, step=7, note="x")
  t2, scalars = checkpoint.restore(p, _zeros_like(tree))
  _assert_bitwise(t2, tree)
  assert isinstance(t2["sol"], Carry) and isinstance(t2["aux"], tuple)
  assert int(scalars["step"]) == 7 and str(scalars["note"]) == "x"


def test_topology_mismatch_fails(tmp_path):
  p = str(tmp_path / "bad.npz")
  checkpoint.save(p, {"U": torch.zeros((3, 4))})
  with pytest.raises(ValueError, match="shape"):
    checkpoint.restore(p, {"U": torch.zeros((5, 4))})
  with pytest.raises(ValueError, match="dtype"):
    checkpoint.restore(p, {"U": torch.zeros((3, 4), dtype=torch.float64)})
  with pytest.raises(ValueError, match="structure"):
    checkpoint.restore(p, {"V": torch.zeros((3, 4))})
  with pytest.raises(ValueError, match="reserved"):
    checkpoint.save(p, {"U": torch.zeros(1)}, leaf_00000=1)


def test_jax_checkpoint_restores_into_the_port_and_back(tmp_path):
  from raisimlib_tpu.utils import checkpoint as jckpt

  jp, tp = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
  jckpt.save(jp, _jax_tree(), iteration=4)
  t, scalars = checkpoint.restore(jp, _zeros_like(_port_tree()))
  assert int(scalars["iteration"]) == 4
  _assert_bitwise(t, _port_tree())
  checkpoint.save(tp, _port_tree(), iteration=5)
  jt, jscalars = jckpt.restore(tp, _jax_tree())
  assert int(jscalars["iteration"]) == 5
  _assert_bitwise(jt, _port_tree())


# ---- kill and resume --------------------------------------------------------------------------


def _worker(workdir, sleep=0.0):
  env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
  return subprocess.Popen(
      [sys.executable, os.path.join(REPO, "tests", "torch_ckpt_worker.py"), str(workdir),
       "--sleep", str(sleep)],
      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO)


def test_kill_and_resume_bitwise(tmp_path):
  golden_dir, crash_dir = tmp_path / "golden", tmp_path / "crash"
  golden_dir.mkdir()
  crash_dir.mkdir()
  golden = _worker(golden_dir)                       # runs beside the crash run
  ckpt = crash_dir / "mppi.ckpt.npz"
  p = _worker(crash_dir, sleep=0.3)
  deadline = time.time() + 120
  killed_at = -1
  while time.time() < deadline:
    if ckpt.exists():
      try:
        with np.load(ckpt, allow_pickle=True) as z:
          killed_at = int(z["scalar_iteration"][()])
      except Exception:
        pass                                         # read mid-replace; retry
      if killed_at >= 1:
        break
    if p.poll() is not None:
      break
    time.sleep(0.02)
  assert p.poll() is None, "worker finished before it could be killed"
  p.send_signal(signal.SIGKILL)
  p.wait(timeout=60)
  assert p.returncode != 0 and killed_at >= 1
  assert not (crash_dir / "result.npy").exists()

  p = _worker(crash_dir)
  out, _ = p.communicate(timeout=120)
  assert p.returncode == 0, out
  assert "resumed from iteration" in out
  out, _ = golden.communicate(timeout=120)
  assert golden.returncode == 0, out
  np.testing.assert_array_equal(np.load(crash_dir / "result.npy"),
                                np.load(golden_dir / "result.npy"))
