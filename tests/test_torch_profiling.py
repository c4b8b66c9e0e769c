"""The port's profiling helpers (raisimlib_torch/utils/profiling.py):

  * tune_sweeps picks the same Gauss-Seidel sweep count as the JAX
    package's on a small sphere scene (a column of two spheres on the
    ground, f64, two worlds, one at rest and one spinning, whose friction
    rows converge over sweeps), with one-step errors that agree to 1e-9:
    the K2 twin against JAX's Pallas kernel in interpret mode. JAX runs a
    reference and one candidate that misses the tolerance (its fallback:
    each candidate is a JAX compile of seconds); the port alone then walks
    a ladder of candidates to the first that meets it;
  * trace on the CPU (time_call is gone): a Chrome trace written after one
    warm-up call, the call's result returned, the profile kept.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import torch

from torch_port_util import one_thread  # noqa: F401  (a module fixture)

from raisimlib_torch.utils import profiling

R = 0.1
REF_SWEEPS, TOL = 16, 1e-3


def _column(World, **kw):
  """Two spheres of radius R stacked 0.1 mm into contact on the ground."""
  w = World(dt=0.002, **kw)
  w.add_ground()
  for k in range(2):
    w.add_sphere(R, 1.0 + k, pos=(0.002 * k, 0.0, R + k * 2 * R - (k + 1) * 1e-4))
  return w.compile()


def _probe(ts):
  from raisimlib_torch.ops.integrator import State

  q = np.tile(ts.model.q_init.numpy(), (2, 1))
  u = np.zeros((2, ts.model.nv))
  u[1, 0::6] = 0.3                                     # world 1: both spheres spinning
  return q, u, np.zeros_like(u), State(q=torch.tensor(q), u=torch.tensor(u),
                                       t=torch.zeros(2, dtype=torch.float64))


def test_tune_sweeps_matches_jax():
  from raisimlib_tpu.ops.integrator import State as JState
  from raisimlib_tpu.utils import profiling as jprof
  from raisimlib_tpu.world import World as JWorld
  from raisimlib_torch.world import World

  js = _column(JWorld, dtype=jnp.float64)
  ts = _column(World, dtype=torch.float64, device="cpu")
  q, u, tau, st = _probe(ts)
  sw_j, err_j = jprof.tune_sweeps(js, JState(q=jnp.asarray(q), u=jnp.asarray(u),
                                             t=jnp.zeros(2)), jnp.asarray(tau),
                                  tol=TOL, candidates=(2,), ref_sweeps=REF_SWEEPS)
  sw_t, err_t = profiling.tune_sweeps(ts, st, torch.tensor(tau), tol=TOL, candidates=(2,),
                                      ref_sweeps=REF_SWEEPS)
  assert sw_t == sw_j == 2 and err_t > TOL, (sw_t, sw_j, err_t, err_j)
  assert abs(err_t - err_j) < 1e-9
  # the ladder: 1, 2 and 4 sweeps miss, 8 meets the tolerance; none of 1-2 does
  sw, err = profiling.tune_sweeps(ts, st, torch.tensor(tau), tol=TOL, candidates=(8, 1, 4, 2),
                                  ref_sweeps=REF_SWEEPS)
  assert sw == 8 and err <= TOL
  assert profiling.tune_sweeps(ts, st, torch.tensor(tau), tol=TOL, candidates=(1, 2),
                               ref_sweeps=REF_SWEEPS)[0] == 2


def test_time_call_and_trace(tmp_path):
  """`trace` alone: the best-of-N `time_call` that stood beside it is gone
  (portbench/ times the port)."""
  x = torch.randn(64, 64)
  calls = []

  def f(a):
    calls.append(1)
    return (a @ a).relu().sum()

  out = profiling.trace(f, x, logdir=str(tmp_path / "trace"))
  assert len(calls) == 2                               # one warm-up call, one traced
  assert float(out) == float(f(x))
  with open(tmp_path / "trace" / "trace.json") as fh:
    events = json.load(fh)["traceEvents"]
  assert any("aten::mm" in e.get("name", "") for e in events)
  assert any("aten::mm" in k.key for k in profiling.trace.last.key_averages())
  assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0
