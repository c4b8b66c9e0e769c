"""Cylinders, cones and convex meshes in the port against the JAX package:
the mesh tables, the World API, the narrow phase on a heightmap and on the
ground plane, and the K2 path's step on terrain.

  * collision.hull_support_sample and build_geom_table's mesh rows (the geom
    offset baked in, padded with vertex 0) equal JAX's exactly in float64.
  * World.add_cylinder / add_cone / add_mesh build JAX's model and geom
    tables (1e-12) and pairs.
  * The heightmap narrow phase (6 cylinder rim probes, the cone's apex and 3
    rim probes, the mesh's 4 deepest vertex probes) and the plane kernels
    agree with JAX eager (vmap without jit) on random tilted poses and on
    poses whose axis is exactly vertical (the downhill frame's fallback),
    to 1e-12, with the same valid flags. A yawed cube on flat ground has 4
    equally deep bottom vertices: both packages select the same ones, in
    vertex order.
  * pipeline.step_batch(field_heights=...) against JAX's
    step_batch(use_kernel=False) in float64 over 4 steps on per-world
    random terrain, for the three bodies of chip_smoke.py (1e-9, the
    tolerance of tests/test_torch_terrain_step.py).

The scenes are built in JAX and carried across with convert.scene_from_numpy
where a test needs the same numbers in both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import (DEBRIS_FIELD, MODEL_FIELDS, debris_drop_states, debris_max_depth,
                             jax_debris_rollout, jax_debris_scene, load_chip_smoke, port_scene)
from torch_port_util import one_thread  # noqa: F401  (a module fixture)

from raisimlib_tpu.ops import collision as jcoll
from raisimlib_tpu.ops import dynamics as jdyn
from raisimlib_tpu.ops import heightmap as jhm
from raisimlib_tpu.world import World as JWorld

B, STEPS = 4, 4
NX, NY = DEBRIS_FIELD["shape"]
SHAPES = ("cylinder", "cone", "mesh")
CS = load_chip_smoke()


# ---- the mesh tables ----------------------------------------------------------------


def _clouds():
  rng = np.random.RandomState(3)
  return {"cube": CS.CUBE, "rock32": CS.rock_vertices(),
          "cloud100": rng.randn(100, 3) * np.array([0.2, 0.1, 0.05])}


@pytest.mark.parametrize("name", ["cube", "rock32", "cloud100"])
def test_hull_tables_match_jax(name):
  """hull_support_sample (a 100-vertex cloud is cut to the support vertices
  of 32 directions, with a warning) and build_geom_table's mesh rows: the
  geom offset baked in, the padding vertex 0, the counts."""
  from raisimlib_tpu.world import _GeomSpec
  from raisimlib_torch.ops import collision as coll

  V = _clouds()[name]
  if name == "cloud100":
    with pytest.warns(UserWarning, match="reducing a 100-vertex hull"):
      hj = jcoll.hull_support_sample(V)
    with pytest.warns(UserWarning, match="reducing a 100-vertex hull"):
      ht = coll.hull_support_sample(V)
    assert 4 <= len(ht) <= 32
  else:
    hj, ht = jcoll.hull_support_sample(V), coll.hull_support_sample(V)
  np.testing.assert_array_equal(ht, hj)
  c, s = np.cos(0.4), np.sin(0.4)
  rot = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
  args = [(-1, jcoll.GEOM_PLANE, np.zeros(4), np.zeros(3), np.eye(3), 0, -1, None),
          (0, jcoll.GEOM_MESH, np.zeros(4), np.array([0.02, -0.01, 0.03]), rot, 0, -1, V)]
  import warnings

  with warnings.catch_warnings():
    warnings.simplefilter("ignore", UserWarning)
    gj = jcoll.build_geom_table([_GeomSpec(*a) for a in args], dtype=jnp.float64)
    gt = coll.build_geom_table([coll.GeomSpec(*a[:7], mesh=a[7]) for a in args],
                               dtype=torch.float64, device="cpu")
  assert gt.mesh_vcount == gj.mesh_vcount == (0, len(hj))
  np.testing.assert_array_equal(gt.mesh_verts.numpy(), np.asarray(gj.mesh_verts))


@pytest.mark.parametrize("name", ["cylinder", "cone", "mesh", "mesh_given_inertia"])
def test_world_api_matches_jax(name):
  """add_cylinder / add_cone / add_mesh (its box inertia by default, or a
  given inertia about a given COM) build JAX's model and geom tables."""
  from raisimlib_torch.world import World

  worlds = []
  for W, kw in ((JWorld, dict(dtype=jnp.float64)),
                (World, dict(dtype=torch.float64, device="cpu"))):
    w = W(dt=0.002, **kw)
    w.add_ground()
    if name == "mesh_given_inertia":
      w.add_mesh(CS.CUBE, 1.5, pos=(0.1, 0.2, 0.5), inertia=np.diag([0.01, 0.02, 0.03]),
                 com=(0.01, 0.0, -0.02))
    else:
      CS.add_debris(w, name)
    worlds.append(w.compile(joint_limits=False))
  js, ts = worlds
  m, mt = js.model, ts.model
  assert (m.parent, m.joint_types, m.q_adr, m.v_adr, m.body_names) == (
      mt.parent, mt.joint_types, mt.q_adr, mt.v_adr, mt.body_names)
  for f in MODEL_FIELDS:
    np.testing.assert_allclose(getattr(mt, f).numpy(), np.asarray(getattr(m, f)), atol=1e-12,
                               rtol=0, err_msg=f)
  g, gt = js.geoms, ts.geoms
  assert (gt.gtype, gt.body, gt.material, gt.mesh_vcount) == (
      g.gtype, g.body, g.material, g.mesh_vcount)
  for f in ("params", "offset_pos", "offset_rot", "mesh_verts"):
    np.testing.assert_allclose(getattr(gt, f).numpy(), np.asarray(getattr(g, f)), atol=1e-12,
                               rtol=0, err_msg=f)
  assert ts.pairs == js.pairs


# ---- the narrow phase -------------------------------------------------------------------


def _poses(n_tilted, n_vertical, seed, z=(0.05, 0.3)):
  """Random positions over the field; n_tilted random orientations, then
  n_vertical turned about z only (the axis exactly vertical), half of them
  upside down."""
  rng = np.random.RandomState(seed)
  n = n_tilted + n_vertical
  q = np.zeros((n, 7))
  q[:, :2] = np.asarray(DEBRIS_FIELD["center"]) + rng.uniform(-1.0, 1.0, (n, 2)) * [1.1, 0.9]
  q[:, 2] = rng.uniform(*z, n)
  quat = rng.randn(n_tilted, 4)
  q[:n_tilted, 3:] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
  yaw = rng.uniform(-np.pi, np.pi, n_vertical)
  up = np.stack([np.cos(yaw / 2), 0 * yaw, 0 * yaw, np.sin(yaw / 2)], 1)
  flip = np.stack([0 * yaw, np.cos(yaw / 2), np.sin(yaw / 2), 0 * yaw], 1)   # x-axis half turn
  q[n_tilted:, 3:] = np.where((np.arange(n_vertical) % 2 == 0)[:, None], up, flip)
  return q


def _compare_slots(slots_t, slots_j):
  assert len(slots_t) == len(slots_j)
  for st, sj in zip(slots_t, slots_j):
    for a, b in zip(st[:3], sj[:3]):
      np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-12, rtol=0)
    np.testing.assert_array_equal(st[3].numpy(), np.asarray(sj[3]))


@pytest.mark.parametrize("name", SHAPES)
def test_narrow_phase_matches_jax(name):
  """The body against a rough heightmap (collide_heightmap) and against the
  plane (the pair kernel), on 48 tilted and 16 vertical-axis poses."""
  from raisimlib_torch.ops import collision as coll
  from raisimlib_torch.ops import dynamics
  from raisimlib_torch.ops import heightmap as hm

  rng = np.random.RandomState(7)
  js = jax_debris_scene(name, heights=rng.uniform(-0.1, 0.1, (NX, NY)), ground=True)
  ts = port_scene(js)
  q = _poses(48, 16, seed=8)
  kin_t = dynamics.fk(ts.model, torch.tensor(q))
  R = kin_t.R[:, 0]
  assert bool((R[48:, :2, 2] == 0.0).all())           # the axis is vertical: fallback frame
  assert bool(((R[48:, 2, 2].abs() - 1.0).abs() < 1e-15).all())
  gi = [g for g, t in enumerate(js.geoms.gtype)
        if t not in (jcoll.GEOM_PLANE, jcoll.GEOM_HEIGHTMAP)][0]
  ip = js.geoms.gtype.index(jcoll.GEOM_PLANE)
  assert (gi, ip) in js.pairs
  slots_j = jax.vmap(lambda qq: jhm.collide_heightmap(
      js.geoms, gi, jdyn.fk(js.model, qq), js.field))(jnp.asarray(q))
  slots_t = hm.collide_heightmap(ts.geoms, gi, kin_t, ts.field)
  assert len(slots_t) == {"cylinder": 6, "cone": 4, "mesh": 4}[name]
  _compare_slots(slots_t, slots_j)
  valid = torch.stack([v for *_, v in slots_t], 1)
  assert 0.05 < float(valid.double().mean()) < 0.95
  jfn = {"cylinder": jcoll._cylinder_plane, "cone": jcoll._cone_plane,
         "mesh": jcoll._mesh_plane}[name]
  key = (ts.geoms.gtype[gi], coll.GEOM_PLANE)
  plane_j = jax.vmap(lambda qq: jfn(js.geoms, gi, ip, jdyn.fk(js.model, qq)))(jnp.asarray(q))
  _compare_slots(coll.SINGLE[key](ts.geoms, gi, ip, kin_t), plane_j)


def test_yawed_cube_selects_the_same_tied_vertices():
  """A cube yawed about z on a flat field, 2 mm into it: its 4 bottom
  vertices are equally deep. The port's selection (collision.deepest4)
  takes them in vertex order, as JAX's lax.top_k does, on the heightmap and
  on the plane."""
  from raisimlib_torch.ops import collision as coll
  from raisimlib_torch.ops import dynamics
  from raisimlib_torch.ops import heightmap as hm

  js = jax_debris_scene("cube", heights=np.full((NX, NY), 0.03), ground=True)
  ts = port_scene(js)
  yaw = np.random.RandomState(9).uniform(-np.pi, np.pi, 16)
  q = np.zeros((16, 7))
  q[:, :2] = np.random.RandomState(10).uniform(-0.8, 0.8, (16, 2))
  q[:, 2] = 0.128
  q[:, 3], q[:, 6] = np.cos(yaw / 2), np.sin(yaw / 2)
  gi = js.geoms.gtype.index(jcoll.GEOM_MESH)
  kin_t = dynamics.fk(ts.model, torch.tensor(q))
  V, mask = coll.mesh_world_verts(ts.geoms, [gi], kin_t)
  _, _, depth, _ = hm._point_contact(ts.field, V, 0.0)
  depth = torch.where(mask, depth, -torch.inf)[:, 0]
  top = coll.deepest4(depth)
  Vj = jax.vmap(lambda qq: jcoll._mesh_world_verts(js.geoms, gi, jdyn.fk(js.model, qq)))(
      jnp.asarray(q))
  # JAX's selection, as its _mesh_hm makes it: lax.top_k of the masked depths
  dj = jax.vmap(lambda p: jhm._point_contact(js.field, p, 0.0)[2])(Vj.reshape(-1, 3))
  _, top_j = jax.lax.top_k(jnp.where(jnp.asarray(mask[0].numpy()), dj.reshape(16, -1),
                                     -jnp.inf), 4)
  bottom = np.flatnonzero(CS.CUBE[:, 2] < 0)
  assert bool((depth[:, bottom] == depth[:, bottom[:1]]).all())       # an exact tie
  np.testing.assert_array_equal(top.numpy(), np.asarray(top_j))
  np.testing.assert_array_equal(top.numpy(), np.tile(bottom, (16, 1)))
  pos = torch.stack([sl[0] for sl in hm.collide_heightmap(ts.geoms, gi, kin_t, ts.field)], 1)
  np.testing.assert_array_equal(pos.numpy(), V[:, 0, bottom].numpy())
  ip = js.geoms.gtype.index(jcoll.GEOM_PLANE)
  kin_p = dynamics.fk(ts.model, torch.tensor(q - np.r_[0, 0, 0.05, 0, 0, 0, 0]))
  _compare_slots(coll._mesh_plane(ts.geoms, gi, ip, kin_p),
                 jax.vmap(lambda qq: jcoll._mesh_plane(js.geoms, gi, ip, jdyn.fk(js.model, qq)))(
                     jnp.asarray(q - np.r_[0, 0, 0.05, 0, 0, 0, 0])))


# ---- the K2 path's step on terrain ------------------------------------------------------


@pytest.mark.parametrize("name", SHAPES)
def test_step_batch_on_terrain_matches_jax_f64(name):
  """4 bodies dropped 1-3 mm over their own random terrains at 1 m/s, 4
  steps: the port's K2 path (its solve's plain twin on the CPU) and JAX's
  pure path agree to 1e-9 (these contacts stick, so the two cone searches
  agree)."""
  from raisimlib_torch.ops import pipeline
  from raisimlib_torch.ops.integrator import State

  js = jax_debris_scene(name)
  ts = port_scene(js)
  hts, q, u = debris_drop_states(ts, B, seed={"cylinder": 21, "cone": 22, "mesh": 23}[name])
  h = torch.tensor(hts)
  s = State(q=torch.tensor(q), u=torch.tensor(u), t=torch.zeros(B, dtype=torch.float64))
  depth = 0.0
  with torch.inference_mode():
    for _ in range(STEPS):
      s = pipeline.step_batch(ts, s, torch.zeros((B, 6), dtype=torch.float64), field_heights=h)
      depth = max(depth, debris_max_depth(ts, s.q, h))
  qj, uj = jax_debris_rollout(js, hts, q, u, STEPS)
  assert depth > 1e-3                             # the bodies are in contact
  np.testing.assert_allclose(s.q.numpy(), qj, atol=1e-9, rtol=0)
  np.testing.assert_allclose(s.u.numpy(), uj, atol=1e-9, rtol=0)
