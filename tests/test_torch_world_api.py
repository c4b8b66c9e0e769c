"""The World and Scene API of the port against the JAX package's, in
float64:

  * add_compound: the model (its default inertia: the children's primitive
    inertias, mass split by volume, moved to the COM; and a given one) and
    the geom tables, to 1e-12;
  * object_names, object_state / set_object_state, body_index, body_pose;
  * external_force, and Scene.step(f_ext_w=...) for 10 steps of a dumbbell
    compound and a sphere on the ground (a world of their own, to keep JAX's
    compile short), pushed by a wrench, against the JAX package's Scene.step
    (jitted), to 1e-10 on q and u.

The scenes are built by the same World calls in both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import MODEL_FIELDS

from raisimlib_tpu.world import World as JWorld

DUMBBELL = [dict(type="sphere", params=[0.05], pos=(-0.1, 0.0, 0.0)),
            dict(type="sphere", params=[0.05], pos=(0.1, 0.0, 0.0)),
            dict(type="capsule", params=[0.025, 0.1],
                 rot=[[0.0, 0.0, 1.0], [0.0, 1.0, 0.0], [-1.0, 0.0, 0.0]])]
MIXED = [dict(type="box", params=[0.1, 0.05, 0.02], pos=(0.0, 0.0, -0.05), material=1),
         dict(type="cylinder", params=[0.03, 0.08], pos=(0.05, 0.02, 0.04)),
         dict(type="sphere", params=[0.04], pos=(-0.06, 0.0, 0.05))]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
  """One intra-op thread for this module: its tensors are a few worlds
  wide, and the test workers share the machine's cores."""
  n = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(n)


def _build(W, full=True, **kw):
  w = W(dt=0.002, **kw)
  w.add_material(0.5, 0.1)
  w.add_ground()
  w.add_compound(DUMBBELL, 1.0, name="dumbbell", pos=(0.0, 0.0, 0.06))
  if full:
    w.add_compound(MIXED, 2.0, name="mixed", pos=(1.0, 0.0, 0.2), com=(0.01, 0.0, -0.01))
    w.add_compound(MIXED[:2], 1.5, name="given", pos=(2.0, 0.0, 0.2),
                   inertia=np.diag([0.01, 0.02, 0.03]))
  w.add_sphere(0.05, 0.3, name="ball", pos=(0.3, 0.0, 0.05))
  return w.compile(joint_limits=False)


@pytest.fixture(scope="module")
def scenes():
  from raisimlib_torch.world import World

  return _build(JWorld, dtype=jnp.float64), _build(World, dtype=torch.float64, device="cpu")


def test_add_compound_matches_jax(scenes):
  """The compounds' bodies (default inertia, with a COM offset, and a given
  inertia) and their geoms: types, bodies, materials, params, offsets."""
  js, ts = scenes
  m, mt = js.model, ts.model
  assert (m.parent, m.joint_types, m.body_names) == (mt.parent, mt.joint_types, mt.body_names)
  for f in MODEL_FIELDS:
    np.testing.assert_allclose(getattr(mt, f).numpy(), np.asarray(getattr(m, f)), rtol=0,
                               atol=1e-12, err_msg=f)
  g, gt = js.geoms, ts.geoms
  assert (gt.gtype, gt.body, gt.material) == (g.gtype, g.body, g.material)
  for f in ("params", "offset_pos", "offset_rot"):
    np.testing.assert_allclose(getattr(gt, f).numpy(), np.asarray(getattr(g, f)), rtol=0,
                               atol=1e-12, err_msg=f)
  assert ts.pairs == js.pairs and ts.objects == js.objects


def test_object_and_body_accessors_match_jax(scenes):
  js, ts = scenes
  assert ts.object_names == js.object_names == ("dumbbell", "mixed", "given", "ball")
  rng = np.random.RandomState(1)
  q = np.asarray(js.model.q_init) + 0.01 * rng.randn(js.model.nq)
  u = rng.randn(js.model.nv)
  sj = js.init_state(q=jnp.asarray(q), u=jnp.asarray(u))
  st = ts.init_state(q=torch.tensor(q), u=torch.tensor(u))
  for name in ts.object_names:
    for a, b in zip(ts.object_state(st, name), js.object_state(sj, name)):
      np.testing.assert_array_equal(a.numpy(), np.asarray(b))
  q_new, u_new = np.array([0.5, 0.4, 0.3, 1.0, 0.0, 0.0, 0.0]), np.arange(6.0)
  sj2 = js.set_object_state(sj, "mixed", q=q_new, u=u_new)
  st2 = ts.set_object_state(st, "mixed", q=q_new, u=u_new)
  np.testing.assert_array_equal(st2.q.numpy(), np.asarray(sj2.q))
  np.testing.assert_array_equal(st2.u.numpy(), np.asarray(sj2.u))
  np.testing.assert_array_equal(st.q.numpy(), q)              # the old state is unchanged
  with pytest.raises(KeyError, match="unknown object"):
    ts.object_state(st, "nothing")
  for body in ts.model.body_names:
    b = ts.body_index(body)
    assert b == js.body_index(body)
    Rj, pj = js.body_pose(sj, body)
    Rt, pt = ts.body_pose(st, body)
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), rtol=0, atol=1e-12)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0, atol=1e-12)
    Rb, pb = ts.body_pose(type(st)(q=st.q[None].expand(3, -1), u=st.u[None].expand(3, -1),
                                   t=st.t[None].expand(3)), body)
    assert Rb.shape == (3, 3, 3) and torch.equal(pb[1], pt)


def test_step_with_external_force_matches_jax():
  """external_force's (nb, 6) table, and 10 steps of Scene.step(f_ext_w=)
  pushing the dumbbell sideways off centre (a force and a torque about the
  world origin), the ball rolling into it."""
  from raisimlib_torch.world import World

  js = _build(JWorld, full=False, dtype=jnp.float64)
  ts = _build(World, full=False, dtype=torch.float64, device="cpu")
  point, force = (0.05, 0.01, 0.08), (3.0, 1.0, 2.0)
  fj = js.external_force("dumbbell", point, force)
  ft = ts.external_force("dumbbell", point, force)
  np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=0, atol=1e-14)
  assert ft.shape == (ts.model.nb, 6) and float(ft[1:].abs().sum()) == 0.0
  u0 = np.zeros(js.model.nv)
  u0[-3] = -1.0                                                # the ball rolls at it
  step = jax.jit(lambda s: js.step(s, f_ext_w=fj))
  sj = js.init_state(u=jnp.asarray(u0))
  st = ts.init_state(u=torch.tensor(u0))
  for _ in range(10):
    sj = step(sj)
    st = ts.step(st, f_ext_w=ft)
  np.testing.assert_allclose(st.q.numpy(), np.asarray(sj.q), rtol=0, atol=1e-10)
  np.testing.assert_allclose(st.u.numpy(), np.asarray(sj.u), rtol=0, atol=1e-10)
  s0 = ts.init_state(u=torch.tensor(u0))
  free = ts.step(s0)
  assert float((ts.step(s0, f_ext_w=ft).u - free.u).abs().max()) > 1e-3   # the push acts
