"""The port's primitives (models/primitives.py), `dynamics.aba` and `energy`,
`convert.model_from_numpy` and `mpc/smooth.py` against the JAX package's.

Tolerances: the tables are built by the same numpy code, so they agree
exactly; `aba`, `energy` and the smooth step in f64 to atol 1e-10 (the same
recursions, summation order aside). The energy drift bound is the JAX
package's own (tests/test_dynamics.py): 2e-3 relative over 5000 steps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import MODEL_FIELDS, jax_anymal_scene, torch_anymal_scene
from torch_port_util import one_thread  # noqa: F401  (a module fixture)

TOL = 1e-10
B = 4
G = np.array([0.0, 0.0, -9.81])
PRIMITIVES = ("pendulum", "double_pendulum", "cartpole", "free_box", "free_sphere")


def _flatten_model(m):
  arrays = {f: np.asarray(getattr(m, f)) for f in MODEL_FIELDS}
  static = dict(name=m.name, parent=m.parent, joint_types=m.joint_types, q_adr=m.q_adr,
                v_adr=m.v_adr, nq=m.nq, nv=m.nv, body_names=m.body_names)
  return arrays, static


def _models(name):
  """(JAX model, the port's carried across by model_from_numpy), f64."""
  from raisimlib_torch.convert import model_from_numpy

  if name == "anymal":
    jm = jax_anymal_scene().model
  else:
    from raisimlib_tpu.models import primitives as jp

    jm = getattr(jp, name)(dtype=jnp.float64)
  return jm, model_from_numpy(*_flatten_model(jm), device="cpu", dtype=torch.float64)


def _states(model, seed):
  """B random (q, u, tau), quaternions normalised."""
  from raisimlib_torch.models.model import JointType

  rng = np.random.default_rng(seed)
  q = np.tile(model.q_init.numpy(), (B, 1)) + 0.5 * rng.standard_normal((B, model.nq))
  for i, jt in enumerate(model.joint_types):
    if JointType(jt) == JointType.FREE:
      qa = model.q_adr[i] + 3
      q[:, qa:qa + 4] /= np.linalg.norm(q[:, qa:qa + 4], axis=1, keepdims=True)
  return q, rng.standard_normal((B, model.nv)), rng.standard_normal((B, model.nv))


@pytest.mark.parametrize("name", PRIMITIVES)
def test_primitive_tables_match_jax(name):
  """Each primitive of the port has the JAX primitive's tables and static
  layout, as carried across by model_from_numpy."""
  from raisimlib_torch.models import primitives as tp

  _, carried = _models(name)
  tm = getattr(tp, name)(dtype=torch.float64, device="cpu")
  for f in ("name", "parent", "joint_types", "q_adr", "v_adr", "nq", "nv", "body_names"):
    assert getattr(tm, f) == getattr(carried, f), f
  for f in MODEL_FIELDS:
    np.testing.assert_array_equal(getattr(tm, f).numpy(), getattr(carried, f).numpy(), err_msg=f)
  assert tm.dtype == torch.float64 and tm.device.type == "cpu"


def test_primitives_default_to_cuda():
  """Device None means the card: without one, building a primitive raises."""
  from raisimlib_torch.models import primitives as tp

  if torch.cuda.is_available():
    assert tp.cartpole().device.type == "cuda"
  else:
    with pytest.raises(RuntimeError, match="device='cpu'"):
      tp.cartpole()


@pytest.mark.parametrize("name,f_ext", [("cartpole", False), ("double_pendulum", False),
                                        ("free_box", True), ("anymal", False),
                                        ("anymal", True)])
def test_aba_matches_jax(name, f_ext):
  """aba on B = 4 random f64 states (and world-frame external forces)
  against the JAX package's aba, vmapped."""
  from raisimlib_tpu.ops import dynamics as jd
  from raisimlib_torch.ops import dynamics as td

  jm, tm = _models(name)
  q, u, tau = _states(tm, seed=len(name))
  fe = np.random.default_rng(5).standard_normal((B, tm.nb, 6)) if f_ext else None
  ref = jax.jit(jax.vmap(lambda a, b, c, f: jd.aba(jm, a, b, c, jnp.asarray(G), f)))(
      q, u, tau, fe)
  got = td.aba(tm, *(torch.tensor(x) for x in (q, u, tau, G)),
               None if fe is None else torch.tensor(fe))
  np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=TOL)


@pytest.mark.parametrize("name", ["double_pendulum", "anymal"])
def test_aba_matches_mass_matrix_solve(name):
  """aba = M^-1 (tau - h) with the port's own M (crba_w) and h, f64."""
  from raisimlib_torch.ops import dynamics as td
  from raisimlib_torch.ops import linalg

  tm = (torch_anymal_scene().model if name == "anymal" else _models(name)[1])
  q, u, tau = (torch.tensor(x) for x in _states(tm, seed=11))
  g = torch.tensor(G)
  M = td.crba_w(tm, q)
  h = td.nonlinearities(tm, q, u, g)
  ref = linalg.cho_solve(linalg.chol(M), (tau - h).unsqueeze(-1)).squeeze(-1)
  np.testing.assert_allclose(td.aba(tm, q, u, tau, g).numpy(), ref.numpy(), rtol=0, atol=TOL)


@pytest.mark.parametrize("name", ["double_pendulum", "free_box", "anymal"])
def test_energy_matches_jax(name):
  from raisimlib_tpu.ops import dynamics as jd
  from raisimlib_torch.ops import dynamics as td

  jm, tm = _models(name)
  q, u, _ = _states(tm, seed=3)
  ke_j, pe_j = jax.jit(jax.vmap(lambda a, b: jd.energy(jm, a, b, jnp.asarray(G))))(q, u)
  ke, pe = td.energy(tm, torch.tensor(q), torch.tensor(u), torch.tensor(G))
  np.testing.assert_allclose(ke.numpy(), np.asarray(ke_j), rtol=0, atol=TOL)
  np.testing.assert_allclose(pe.numpy(), np.asarray(pe_j), rtol=0, atol=TOL)


@pytest.mark.parametrize("substeps", [1, 2])
def test_smooth_dyn_matches_jax(substeps):
  """make_smooth_dyn's batched cartpole step (the pole unactuated) against
  the JAX package's per-world dyn, vmapped, f64."""
  from raisimlib_tpu.mpc.smooth import make_smooth_dyn as jmake
  from raisimlib_torch.mpc.smooth import actuated_indices, make_smooth_dyn

  jm, tm = _models("cartpole")
  jdyn, nx, nu = jmake(jm, jnp.asarray(G), 0.02, substeps)
  tdyn, tnx, tnu = make_smooth_dyn(tm, G, 0.02, substeps)
  assert (tnx, tnu) == (nx, nu) == (4, 1)
  assert actuated_indices(tm).tolist() == [0]
  rng = np.random.default_rng(substeps)
  X, U = rng.standard_normal((B, nx)), 5.0 * rng.standard_normal((B, nu))
  ref = jax.jit(jax.vmap(lambda x, u: jdyn(x, u, 0)))(X, U)
  got = tdyn(torch.tensor(X), torch.tensor(U), 0)
  np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=TOL)


def test_smooth_dyn_refuses_a_free_joint():
  from raisimlib_torch.models import primitives as tp
  from raisimlib_torch.mpc.smooth import make_smooth_dyn

  with pytest.raises(ValueError, match="state_map"):
    make_smooth_dyn(tp.free_box(dtype=torch.float64, device="cpu"), G, 0.01)


def test_double_pendulum_energy_drift():
  """The JAX package's conservation check on the port: the unforced double
  pendulum (m 1.3 / 0.7, l 0.9 / 1.1) from q (1.2, -0.6), u (0.3, -0.2),
  5000 semi-implicit steps of 1e-4 s through make_smooth_dyn, f64: the total
  energy within 2e-3 relative."""
  from raisimlib_torch.models import primitives as tp
  from raisimlib_torch.mpc.smooth import make_smooth_dyn
  from raisimlib_torch.ops import dynamics as td

  m = tp.double_pendulum(m1=1.3, m2=0.7, l1=0.9, l2=1.1, dtype=torch.float64, device="cpu")
  dyn, _, nu = make_smooth_dyn(m, G, 1e-4)
  x = torch.tensor([[1.2, -0.6, 0.3, -0.2]], dtype=torch.float64)
  zero = torch.zeros((1, nu), dtype=torch.float64)
  g = torch.tensor(G)
  e0 = sum(td.energy(m, x[:, :2], x[:, 2:], g))
  for _ in range(5000):
    x = dyn(x, zero, 0)
  e1 = sum(td.energy(m, x[:, :2], x[:, 2:], g))
  assert abs(float(e1 - e0)) / abs(float(e0)) < 2e-3
