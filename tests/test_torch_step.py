"""The port's batched ANYmal step vs the JAX package's, f64, from perturbed
settled states (never from raw standing_q, where a 1e-7 change flips a
contact branch: tests/test_parity.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import (jax_anymal_scene, load_golden, perturbed_states,
                             torch_anymal_scene)

B, N = 4, 5


@pytest.fixture(scope="module")
def reference():
  """Inputs, and JAX's pure-path (use_kernel=False) trajectory of N steps."""
  from raisimlib_tpu.ops import pipeline as jp
  from raisimlib_tpu.ops.integrator import State as JState

  g = load_golden()
  js = jax_anymal_scene()
  q, u = perturbed_states(g, B, seed=3, dq=1e-4, du=1e-3)
  tgts = np.stack([np.tile(g["pd_targets"][k], (B, 1)) for k in range(N)])

  @jax.jit
  def run(q, u, tgts):
    def body(s, tgt):
      s = jp.step_batch(js, s, jnp.zeros_like(tgt), tgt, use_kernel=False)
      return s, (s.q, s.u)

    _, out = jax.lax.scan(body, JState(q=q, u=u, t=jnp.zeros(B)), tgts)
    return out

  qs, us = run(q, u, tgts)
  return q, u, tgts, np.asarray(qs), np.asarray(us)


def _run_port(q, u, tgts, use_kernel):
  from raisimlib_torch.ops import pipeline as tp
  from raisimlib_torch.ops.integrator import State

  ts = torch_anymal_scene()
  s = State(q=torch.tensor(q), u=torch.tensor(u), t=torch.zeros(B, dtype=torch.float64))
  qs, us = [], []
  with torch.inference_mode():
    for tgt in tgts:
      tgt = torch.tensor(tgt)
      s = tp.step_batch(ts, s, torch.zeros_like(tgt), tgt, use_kernel=use_kernel)
      qs.append(s.q.numpy())
      us.append(s.u.numpy())
  return np.stack(qs), np.stack(us)


def test_pure_path_matches_jax(reference):
  """Same algorithm, both f64: 1e-9 absolute on q and u over 5 steps."""
  q, u, tgts, qj, uj = reference
  qt, ut = _run_port(q, u, tgts, use_kernel=False)
  assert np.abs(qt - qj).max() < 1e-9
  assert np.abs(ut - uj).max() < 1e-9


def test_kernel_path_matches_jax_pure_path(reference):
  """use_kernel=True on the CPU runs the kernel's plain twin (grid +
  refinements + parabola instead of grid + Newton): held to the same bounds as
  the JAX package's own kernel-vs-pure step test (tests/test_pallas_contact.py:
  5e-4 on q, 5e-3 on u)."""
  q, u, tgts, qj, uj = reference
  qt, ut = _run_port(q, u, tgts, use_kernel=True)
  np.testing.assert_allclose(qt, qj, atol=5e-4, rtol=1e-4)
  np.testing.assert_allclose(ut, uj, atol=5e-3, rtol=1e-3)


def test_step_batch_rejects_heightfields():
  from raisimlib_torch.ops import pipeline as tp
  from raisimlib_torch.ops.integrator import State

  ts = torch_anymal_scene()
  s = ts.init_state()
  s = State(q=s.q[None], u=s.u[None], t=s.t[None])
  with pytest.raises(NotImplementedError, match="ROADMAP"):
    tp.step_batch(ts, s, torch.zeros(1, 18, dtype=torch.float64),
                  field_heights=torch.zeros(1, 4, 4))
