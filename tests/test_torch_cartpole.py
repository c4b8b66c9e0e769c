"""The port's cartpole swing-up example (raisimlib_torch/examples/
cartpole_swingup.py, BASELINE config 1) against the JAX package's
examples/cartpole_swingup.py: its batched costs against the JAX example's
per-sample expressions under vmap (f64, to 1e-12 relative), and its run() on
the CPU at the scenario's smoke size (10 iterations): every key of the JAX
example's record, finite, the record in the metrics file. The full-size
solve is held to the golden in tests/test_torch_ilqr.py and, on the card,
in chip_smoke.py (phase 34)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import jax_record_keys
from torch_port_util import one_thread  # noqa: F401  (a module fixture)


def test_cartpole_costs_match_jax_vmap():
  """examples/cartpole_swingup.py's rc/fc (the same expressions, the
  scenario's weights), vmapped, against the port's batched cartpole_costs."""
  from raisimlib_torch import scenarios
  from raisimlib_torch.examples.cartpole_swingup import cartpole_costs

  cfg = scenarios.load("cartpole_swingup")
  cw, dt = cfg["run"]["cost"], float(cfg["model"]["dt"])

  def rc(x, u, t):
    return (cw["upright"] * (jnp.cos(x[1]) + 1.0) + cw["cart"] * x[0] ** 2
            + cw["vel"] * (x[2] ** 2 + x[3] ** 2)
            + cw["effort"] * jnp.sum(u**2)) * dt

  def fc(x):
    return (cw["final_upright"] * (jnp.cos(x[1]) + 1.0)
            + 2.0 * x[0] ** 2 + x[2] ** 2 + x[3] ** 2)

  rng = np.random.default_rng(0)
  X, U, t = rng.standard_normal((16, 4)), 10.0 * rng.standard_normal((16, 1)), np.arange(16)
  trc, tfc = cartpole_costs(cw, dt)
  np.testing.assert_allclose(trc(torch.tensor(X), torch.tensor(U), torch.tensor(t)).numpy(),
                             np.asarray(jax.vmap(rc)(X, U, t)), rtol=1e-12)
  np.testing.assert_allclose(tfc(torch.tensor(X)).numpy(), np.asarray(jax.vmap(fc)(X)),
                             rtol=1e-12)


def test_example_runs_on_the_cpu(tmp_path):
  from raisimlib_torch.examples import cartpole_swingup

  path = str(tmp_path / "cartpole_swingup.jsonl")
  res = cartpole_swingup.run(smoke=True, device="cpu", metrics_path=path)
  missing = jax_record_keys("cartpole_swingup") - set(res)
  assert not missing, missing
  assert res["iters"] == 10 and res["horizon"] == 50 and res["device"] == "cpu"
  assert np.isfinite(res["cost"]) and np.isfinite(res["final_theta"])
  assert res["U"].shape == (50, 1) and np.all(np.isfinite(res["U"]))
  with open(path) as f:
    rec = json.loads(f.readlines()[-1])
  assert rec["cost"] == res["cost"] and "U" not in rec
