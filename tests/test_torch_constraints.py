"""Wires, pins and compliant wires in the port against the JAX package, in
float64, at seeded random states:

  * build_tables: the limit rows and the wire, pin and compliant-wire
    specs (the port's NamedTuples, field for field the JAX package's);
  * constraint_rows: the limit, wire and pin rows (J, bias, mu, active), to
    1e-10, with wires and pins between two bodies and to the world, taut
    and slack;
  * compliant_forces: the (nb, 6) wrenches, stretched and slack, to 1e-10;
  * the bias term h with those forces (RNEA's f_ext_w), to 1e-10.

The scenes are built by the same World calls in both packages. Every JAX
call is a pure function (no Pallas kernel lies on the constraint path),
run eagerly under vmap."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raisimlib_tpu.ops import constraints as jcs
from raisimlib_tpu.ops import dynamics as jdyn
from raisimlib_tpu.world import World as JWorld

from torch_port_util import one_thread  # noqa: F401  (a module fixture)

B = 8
TOL = 1e-10


def _build(W, **kw):
  """A hinged pendulum with joint limits, and loose bodies tied by every
  kind of constraint: a sphere on a wire from the world, two spheres on a
  wire between them, a box pinned to the world, a box pinned to that box,
  and compliant wires from the world and between two bodies."""
  w = W(dt=0.001, **kw)
  link = dict(parent=-1, joint=1, axis=[0.0, 1.0, 0.0], mass=1.0, com=[0.0, 0.0, -0.3],
              inertia=np.eye(3) * 0.01, pos=[0.0, -3.0, 1.0], q_lo=-0.5, q_hi=0.6, name="link")
  w.add_articulated_system([link], name="pendulum")
  s1 = w.add_sphere(0.05, 1.0, pos=(0.6, 0.0, 1.0), name="s1")
  w.add_stiff_wire(-1, (0.0, 0.0, 1.6), s1.body_start, (0.0, 0.0, 0.0), length=0.85)
  s2 = w.add_sphere(0.05, 0.5, pos=(0.6, 0.5, 1.0), name="s2")
  s3 = w.add_sphere(0.05, 0.7, pos=(0.6, 0.9, 1.0), name="s3")
  w.add_stiff_wire(s2.body_start, (0.0, 0.05, 0.0), s3.body_start, (0.0, -0.05, 0.0),
                   length=0.35)
  b1 = w.add_box((0.2, 0.05, 0.05), 1.0, pos=(0.2, 2.0, 1.0), name="b1")
  w.add_pin(b1.body_start, (-0.2, 0.0, 0.0), -1, (0.0, 2.0, 1.0))
  b2 = w.add_box((0.1, 0.05, 0.05), 0.5, pos=(0.5, 2.0, 1.0), name="b2")
  w.add_pin(b1.body_start, (0.2, 0.0, 0.0), b2.body_start, (-0.1, 0.0, 0.0))
  c1 = w.add_sphere(0.05, 1.0, pos=(0.0, -2.0, 0.95), name="c1")
  w.add_compliant_wire(-1, (0.0, -2.0, 1.5), c1.body_start, (0.0, 0.0, 0.0), length=0.5,
                       stiffness=200.0, damping=30.0)
  w.add_compliant_wire(s1.body_start, (0.02, 0.0, 0.0), c1.body_start, (0.0, 0.01, 0.0),
                       length=2.0, stiffness=50.0, damping=3.0)
  return w.compile(joint_limits=True)


@pytest.fixture(scope="module")
def scenes():
  """Both packages' scenes and B seeded states around q0 (positions +-0.1
  m, orientations and the joint angle perturbed, velocities N(0, 1)), so
  that wires go taut and slack, the limit rows engage and springs stretch."""
  from raisimlib_torch.world import World

  js = _build(JWorld, dtype=jnp.float64)
  ts = _build(World, dtype=torch.float64, device="cpu")
  rng = np.random.RandomState(5)
  q = np.tile(np.asarray(js.model.q_init), (B, 1))
  q[:, 0] = rng.uniform(-0.8, 0.8, B)                      # across both limits
  for b in range(1, js.model.nb):
    qa = js.model.q_adr[b]
    q[:, qa:qa + 3] += rng.uniform(-0.1, 0.1, (B, 3))
    quat = q[:, qa + 3:qa + 7] + 0.2 * rng.randn(B, 4)
    q[:, qa + 3:qa + 7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
  u = rng.randn(B, js.model.nv)
  return js, ts, q, u


def test_build_tables_match_jax(scenes):
  js, ts, _, _ = scenes
  tj, tt = js.constraints, ts.constraints
  assert tt.limit_vadr == tj.limit_vadr == (0,) and tt.limit_qadr == tj.limit_qadr
  assert tt.limit_lo == tj.limit_lo and tt.limit_hi == tj.limit_hi
  for a, b in ((tt.wires, tj.wires), (tt.pins, tj.pins), (tt.compliant, tj.compliant)):
    assert len(a) == len(b) == 2
    assert [tuple(x) for x in a] == [tuple(x) for x in b]
    assert all(type(x).__name__ == type(y).__name__ for x, y in zip(a, b))
  assert tt.n_rows == tj.n_rows == 5 and tt.row_kinds == tj.row_kinds


def test_constraint_rows_match_jax(scenes):
  """J, bias, mu and active of the limit, wire and pin rows, taut and
  slack wires among the states."""
  from raisimlib_torch.ops import constraints as cs
  from raisimlib_torch.ops import dynamics

  js, ts, q, u = scenes
  dt, erp, mc = 0.001, 0.2, 1.0

  def one(qq, uu):
    kin = jdyn.fk(js.model, qq, uu)
    return jcs.constraint_rows(js.model, js.constraints, kin, qq, uu, dt, erp, mc, jnp.float64)

  ref = jax.vmap(one)(jnp.asarray(q), jnp.asarray(u))
  qt, ut = torch.tensor(q), torch.tensor(u)
  got = cs.constraint_rows(ts.model, ts.constraints, dynamics.fk(ts.model, qt, ut), qt, ut, dt,
                           erp, mc)
  for name, r, g in zip(("J", "bias", "mu", "active"), ref, got):
    np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=TOL, err_msg=name)
  act = got[3].numpy()
  assert 0 < act[:, 1:3].sum() < 2 * B, "the wires should be taut in some states, slack in others"
  assert 0 < act[:, 0].sum() < B, "the limit row should engage in some states"


def test_compliant_forces_and_bias_match_jax(scenes):
  """compliant_forces (stretched and slack springs) and the bias term h
  that RNEA makes of them with a user wrench added."""
  from raisimlib_torch.ops import constraints as cs
  from raisimlib_torch.ops import dynamics

  js, ts, q, u = scenes
  wrench = np.random.RandomState(2).randn(js.model.nb, 6)

  def one(qq, uu):
    kin = jdyn.fk(js.model, qq, uu)
    f = jcs.compliant_forces(js.model, js.constraints, kin, uu, jnp.float64)
    return f, jdyn.nonlinearities(js.model, qq, uu, js.gravity, f + jnp.asarray(wrench))

  f_ref, h_ref = jax.vmap(one)(jnp.asarray(q), jnp.asarray(u))
  qt, ut = torch.tensor(q), torch.tensor(u)
  f = cs.compliant_forces(ts.model, ts.constraints, dynamics.fk(ts.model, qt, ut), ut)
  np.testing.assert_allclose(f.numpy(), np.asarray(f_ref), rtol=0, atol=TOL)
  h = dynamics.nonlinearities(ts.model, qt, ut, ts.gravity, f + torch.tensor(wrench))
  np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), rtol=0, atol=TOL)
  stretched = (np.abs(f.numpy()).sum(-1) > 0)
  assert stretched.any() and (~stretched[:, 1]).any(), "stretched and slack springs"
