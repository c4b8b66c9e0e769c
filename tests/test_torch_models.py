"""The port's ANYmal model, geom and material tables equal the JAX package's,
and scene_from_numpy carries a JAX scene across unchanged."""

import numpy as np
import pytest
import torch

from torch_port_util import (MODEL_FIELDS, flatten_jax_scene, jax_anymal_scene,
                             torch_anymal_scene)


@pytest.fixture(scope="module")
def scenes():
  return jax_anymal_scene(), torch_anymal_scene()


def _assert_same_scene(ts, js_arrays, js_static):
  """Integers and static data exact; f64 values within 1e-12."""
  m = ts.model
  for f in ("name", "parent", "joint_types", "q_adr", "v_adr", "nq", "nv",
            "body_names"):
    assert getattr(m, f) == js_static[f], f
  for f in MODEL_FIELDS:
    np.testing.assert_allclose(getattr(m, f).numpy(), js_arrays[f], rtol=0,
                               atol=1e-12, err_msg=f)
  assert ts.geoms.gtype == js_static["gtype"]
  assert ts.geoms.body == js_static["geom_body"]
  assert ts.geoms.material == js_static["geom_material"]
  for f, k in (("params", "geom_params"), ("offset_pos", "geom_offset_pos"),
               ("offset_rot", "geom_offset_rot")):
    np.testing.assert_allclose(getattr(ts.geoms, f).numpy(), js_arrays[k],
                               rtol=0, atol=1e-12, err_msg=f)
  for f in ("materials", "gravity", "kp", "kd"):
    np.testing.assert_allclose(getattr(ts, f).numpy(), js_arrays[f], rtol=0,
                               atol=1e-12, err_msg=f)
  assert ts.pairs == js_static["pairs"]
  assert tuple(ts.constraints) == js_static["constraints"]
  assert ts.dt == js_static["dt"]
  assert ts.objects == js_static["objects"]


def test_world_compile_matches_jax(scenes):
  js, ts = scenes
  arrays, static = flatten_jax_scene(js)
  _assert_same_scene(ts, arrays, static)
  # the main path's solver layout: 4 feet + 8 base corners, 12 limit rows
  from raisimlib_torch.ops import pipeline

  assert pipeline.scene_row_kinds(ts) == ("cone",) * 12 + ("lin",) * 12
  assert (ts.model.nq, ts.model.nv) == (19, 18)


def test_scene_from_numpy_matches_world_compile(scenes):
  from raisimlib_torch.convert import scene_from_numpy

  js, ts = scenes
  arrays, static = flatten_jax_scene(js)
  cs = scene_from_numpy(arrays, static, device="cpu", dtype=torch.float64)
  _assert_same_scene(cs, arrays, static)
  assert cs.model.joint_types == ts.model.joint_types
  assert cs.constraints == ts.constraints


def test_mesh_geometry_raises():
  from raisimlib_torch.models.urdf import load_urdf

  urdf = ('<robot name="m"><link name="a"><collision><geometry>'
          '<mesh filename="x.obj"/></geometry></collision></link></robot>')
  with pytest.raises(NotImplementedError, match="ROADMAP"):
    load_urdf(urdf)


def _prims_world(pkg, dtype):
  """One FREE body carrying a sphere, a box and a capsule over the ground,
  with an extra material and a pair property: every ported pair type."""
  if pkg == "jax":
    from raisimlib_tpu.world import World
    w = World(dt=0.002, dtype=dtype)
  else:
    from raisimlib_torch.world import World
    w = World(dt=0.002, dtype=dtype, device="cpu")
  rot = np.array([[1.0, 0, 0], [0, 0.8, -0.6], [0, 0.6, 0.8]])
  body = dict(parent=-1, joint=0, mass=2.0, com=[0.01, 0, 0],
              inertia=np.diag([0.02, 0.03, 0.04]), actuated=False,
              q_init=[0, 0, 0.07, 1, 0, 0, 0])
  mat = w.add_material(0.5, 0.2, 0.01)
  geoms = [dict(body=0, gtype=0, params=[0.05], offset_pos=[0.1, 0, 0]),
           dict(body=0, gtype=1, params=[0.1, 0.05, 0.04], offset_rot=rot,
                material=mat),
           dict(body=0, gtype=2, params=[0.03, 0.08], offset_pos=[0, 0.1, 0],
                offset_rot=rot)]
  w.add_articulated_system([body], name="prims", geoms=geoms)
  w.add_ground(0.01)
  w.set_material_pair_prop(0, mat, 0.3, 0.1)
  return w


def test_material_table_and_collide_match_jax():
  """Material table, and the grouped narrow phase (plus the single-pair
  forms it matches slot for slot) against the JAX package's collide."""
  import jax
  import jax.numpy as jnp
  from raisimlib_tpu.ops import collision as jc
  from raisimlib_tpu.ops import dynamics as jd
  from raisimlib_torch.ops import collision as tc
  from raisimlib_torch.ops import dynamics as td

  wj, wt = _prims_world("jax", jnp.float64), _prims_world("torch", torch.float64)
  np.testing.assert_allclose(wt._material_pair_table(), wj._material_pair_table(),
                             rtol=0, atol=0)
  sj, st = wj.compile(), wt.compile()
  assert st.pairs == sj.pairs and len(st.pairs) == 3
  rng = np.random.default_rng(4)
  B = 3
  q = np.tile(np.asarray(sj.model.q_init), (B, 1))
  q[:, :3] += 0.02 * rng.standard_normal((B, 3))
  q[:, 3:7] += 0.3 * rng.standard_normal((B, 4))
  q[:, 3:7] /= np.linalg.norm(q[:, 3:7], axis=1, keepdims=True)
  cj = jax.vmap(lambda a: jc.collide(sj.geoms, sj.pairs, jd.fk(sj.model, a)))(q)
  kt = td.fk(st.model, torch.tensor(q))
  ct = tc.collide(st.geoms, st.pairs, kt)
  for f in ("pos", "normal", "depth", "active"):
    np.testing.assert_allclose(getattr(ct, f).numpy(), np.asarray(getattr(cj, f)),
                               rtol=0, atol=1e-12, err_msg=f)
  for f in ("body_a", "body_b", "mat_a", "mat_b"):
    assert getattr(ct, f) == getattr(cj, f)
  assert 0.0 < float(ct.active.mean()) < 1.0
  # the single-pair forms give the same slots
  rows = [slot for ia, ib in st.pairs
          for slot in tc.SINGLE[(st.geoms.gtype[ia], st.geoms.gtype[ib])](st.geoms, ia, ib, kt)]
  np.testing.assert_allclose(torch.stack([r[0] for r in rows], 1).numpy(), ct.pos.numpy(),
                             rtol=0, atol=1e-12)
  np.testing.assert_allclose(torch.stack([r[2] for r in rows], 1).numpy(), ct.depth.numpy(),
                             rtol=0, atol=1e-12)


def test_unported_pair_raises():
  """Every pair of the JAX package's table has a narrow phase (two boxes
  compile); a pair outside it (a plane attached to a body, against the
  ground) raises and names the pair, where the JAX package drops it with a
  warning."""
  from raisimlib_torch.world import World

  body = dict(parent=-1, joint=0, mass=1.0, inertia=np.eye(3) * 0.01)
  w = World(device="cpu")
  w.add_articulated_system([body], name="a", geoms=[dict(body=0, gtype=1, params=[0.1] * 3)])
  w.add_articulated_system([body], name="b", geoms=[dict(body=0, gtype=1, params=[0.1] * 3)])
  assert w.compile().pairs == ((0, 1),)
  w = World(device="cpu")
  w.add_articulated_system([body], name="a", geoms=[dict(body=0, gtype=3, params=[0.0])])
  w.add_ground()
  with pytest.raises(NotImplementedError, match=r"\(plane, plane\) has no narrow phase"):
    w.compile()
