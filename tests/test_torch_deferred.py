"""The functions the port took last from the JAX package's modules, against
the JAX package's:

  * dynamics.crba, fk_levels, fk_reference and nonlinearities_w on random
    f64 ANYmal states, 1e-10 (the same recursions and contractions, summed
    in another order at most), and each against its sibling in the port
    (crba_w, fk, nonlinearities);
  * linalg.spd_solve, integrator.step_smooth and Scene.step_smooth (the
    cartpole and ANYmal), 1e-10;
  * state_map.make_contact_dyn (one world, 2 substeps of Scene.step) on a
    two-link arm whose tip sphere meets the ground (ANYmal costs JAX a
    compile of 7 s), 1e-9, the tolerance of the port's reference step;
  * anymal.joint_order, equal;
  * urdf.load_mesh_vertices on OBJ, ASCII STL and binary STL files that the
    test writes, equal to JAX's; then a URDF whose link carries a mesh
    collision geom builds the same model and geom tables in both packages.
"""

import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import MODEL_FIELDS, jax_anymal_scene, torch_anymal_scene
from torch_port_util import one_thread  # noqa: F401  (a module fixture)

from raisimlib_tpu.ops import dynamics as jd
from raisimlib_torch.ops import dynamics as td

TOL = 1e-10
B = 4


@pytest.fixture(scope="module")
def anymal():
  js, ts = jax_anymal_scene(), torch_anymal_scene()
  rng = np.random.default_rng(21)
  q = np.tile(np.asarray(js.model.q_init), (B, 1))
  q[:, :3] += 0.3 * rng.standard_normal((B, 3))
  q[:, 3:7] = rng.standard_normal((B, 4))
  q[:, 3:7] /= np.linalg.norm(q[:, 3:7], axis=1, keepdims=True)
  q[:, 7:] += 0.5 * rng.standard_normal((B, 12))
  return js, ts, q, rng.standard_normal((B, 18))


def _close(a, b, tol=TOL):
  np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=tol)


@pytest.mark.parametrize("fn", ["fk_levels", "fk_reference"])
def test_fk_variants_match_jax(anymal, fn):
  js, ts, q, u = anymal
  kj = jax.jit(jax.vmap(lambda a, b: getattr(jd, fn)(js.model, a, b)))(q, u)
  kt = getattr(td, fn)(ts.model, torch.tensor(q), torch.tensor(u))
  kf = td.fk(ts.model, torch.tensor(q), torch.tensor(u))
  for f in ("R", "p", "S_w", "vel6", "Xup_E", "Xup_r"):
    _close(getattr(kt, f).numpy(), getattr(kj, f))
    _close(getattr(kt, f).numpy(), getattr(kf, f).numpy())


def test_crba_and_nonlinearities_w_match_jax(anymal):
  js, ts, q, u = anymal
  qt, ut = torch.tensor(q), torch.tensor(u)
  Mj = jax.jit(jax.vmap(lambda a: jd.crba(js.model, a)))(q)
  Mt = td.crba(ts.model, qt)
  _close(Mt.numpy(), Mj)
  _close(Mt.numpy(), td.crba_w(ts.model, qt).numpy())
  hj = jax.jit(jax.vmap(lambda a, b: jd.nonlinearities_w(js.model, a, b, js.gravity)))(q, u)
  ht = td.nonlinearities_w(ts.model, qt, ut, ts.gravity)
  _close(ht.numpy(), hj)
  _close(ht.numpy(), td.nonlinearities(ts.model, qt, ut, ts.gravity).numpy())


def test_spd_solve_matches_jax():
  from raisimlib_tpu.ops import linalg as jl
  from raisimlib_torch.ops import linalg as tl

  rng = np.random.default_rng(5)
  A = rng.standard_normal((3, 7, 7))
  A = A @ A.transpose(0, 2, 1) + 7 * np.eye(7)
  Bm = rng.standard_normal((3, 7, 2))
  xt = tl.spd_solve(torch.tensor(A), torch.tensor(Bm)).numpy()
  _close(xt, jax.jit(jax.vmap(jl.spd_solve))(A, Bm))
  _close(A @ xt, Bm)


@pytest.mark.parametrize("robot", ["cartpole", "anymal"])
def test_step_smooth_matches_jax(anymal, robot):
  """integrator.step_smooth on a batch, and Scene.step_smooth on one world
  (its first, held to the same JAX step: Scene.step_smooth is that step)."""
  from raisimlib_tpu.ops import integrator as ji
  from raisimlib_torch.ops import integrator as ti

  js, ts, q, u = anymal
  rng = np.random.default_rng(9)
  if robot == "cartpole":
    from raisimlib_tpu.models import primitives as jp
    from raisimlib_torch.models import primitives as tp

    jm, tm = jp.cartpole(dtype=jnp.float64), tp.cartpole(dtype=torch.float64, device="cpu")
    q, u = rng.standard_normal((B, 2)), rng.standard_normal((B, 2))
  else:
    jm, tm = js.model, ts.model
  g, dt = np.asarray(js.gravity), js.dt         # the scene's, for Scene.step_smooth
  tau = 5.0 * rng.standard_normal(q.shape[:1] + (jm.nv,))
  sj = jax.jit(jax.vmap(lambda a, b, c: ji.step_smooth(
      jm, ji.State(q=a, u=b, t=jnp.zeros(())), c, jnp.asarray(g), dt)))(q, u, tau)
  st = ti.step_smooth(tm, ti.State(q=torch.tensor(q), u=torch.tensor(u),
                                   t=torch.zeros(B, dtype=torch.float64)),
                      torch.tensor(tau), torch.tensor(g), dt)
  _close(st.q.numpy(), sj.q)
  _close(st.u.numpy(), sj.u)
  _close(st.t.numpy(), np.full(B, dt))
  if robot == "anymal":
    one = ts.step_smooth(ti.State(q=torch.tensor(q[0]), u=torch.tensor(u[0]),
                                  t=torch.zeros((), dtype=torch.float64)), torch.tensor(tau[0]))
    _close(one.q.numpy(), sj.q[0])
    _close(one.u.numpy(), sj.u[0])


def _arm(World, **kw):
  """A two-link revolute arm (shoulder 0.35 m up, links of 0.3 m) whose
  forearm tip carries a sphere of 5 cm over the ground, PD gains 50 / 1."""
  I = np.diag([0.01, 0.01, 0.01])
  bodies = [dict(parent=-1, joint=1, axis=[0, 1, 0], pos=[0, 0, 0.35], mass=1.0,
                 com=[0.15, 0, 0], inertia=I, name="upper"),
            dict(parent=0, joint=1, axis=[0, 1, 0], pos=[0.3, 0, 0], mass=0.5,
                 com=[0.15, 0, 0], inertia=0.5 * I, name="fore")]
  w = World(dt=0.005, **kw)
  w.add_articulated_system(bodies, name="arm",
                           geoms=[dict(body=1, gtype=0, params=[0.05], offset_pos=[0.3, 0, 0])])
  w.add_ground()
  return w.compile().set_pd_gains(50.0, 1.0)


def test_make_contact_dyn_matches_jax():
  """One world through 2 substeps of Scene.step: the arm's tip sphere 0.6
  mm into the ground and moving down, its PD targets pressing it in."""
  from raisimlib_tpu.mpc import state_map as jsm
  from raisimlib_tpu.world import World as JWorld
  from raisimlib_torch.mpc import state_map as tsm
  from raisimlib_torch.world import World

  js, ts = _arm(JWorld, dtype=jnp.float64), _arm(World, dtype=torch.float64, device="cpu")
  x, a = np.array([0.5, 0.05, 0.3, -0.8]), np.array([0.6, 0.3])   # 0.6 mm deep
  dj, nxj, nuj = jsm.make_contact_dyn(js, 0.01, 2)
  dt_, nxt, nut = tsm.make_contact_dyn(ts, 0.01, 2)
  assert (nxt, nut) == (nxj, nuj) == (4, 2)
  xj = jax.jit(dj)(x, a, 0)
  xt = dt_(torch.tensor(x), torch.tensor(a), 0)
  _close(xt.numpy(), xj, 1e-9)
  with pytest.raises(ValueError, match="control_dt"):
    tsm.make_contact_dyn(ts, 0.01, 3)


def test_joint_order_matches_jax():
  from raisimlib_tpu.models import anymal as jan
  from raisimlib_torch.models import anymal as tan

  assert tan.joint_order() == jan.joint_order()
  assert len(tan.joint_order()) == 12


# ---- mesh files ---------------------------------------------------------------------------


def _tetra_box():
  """A box's 8 corners and the 12 triangles of its faces."""
  V = np.array([[x, y, z] for x in (-0.1, 0.1) for y in (-0.05, 0.05) for z in (-0.02, 0.03)])
  faces = [(0, 1, 3), (0, 3, 2), (4, 6, 7), (4, 7, 5), (0, 4, 5), (0, 5, 1),
           (2, 3, 7), (2, 7, 6), (0, 2, 6), (0, 6, 4), (1, 5, 7), (1, 7, 3)]
  return V, faces


def _write_meshes(d):
  V, faces = _tetra_box()
  obj = d / "box.obj"
  obj.write_text("# a box\n" + "".join(f"v {x} {y} {z}\n" for x, y, z in V)
                 + "".join(f"f {a + 1} {b + 1} {c + 1}\n" for a, b, c in faces))
  ascii_stl = d / "box_ascii.stl"
  body = "".join("  facet normal 0 0 0\n    outer loop\n"
                 + "".join(f"      vertex {V[i][0]} {V[i][1]} {V[i][2]}\n" for i in f)
                 + "    endloop\n  endfacet\n" for f in faces)
  ascii_stl.write_text(f"solid box\n{body}endsolid box\n")
  bin_stl = d / "box_bin.stl"
  raw = bytearray(80) + struct.pack("<I", len(faces))
  for f in faces:
    raw += struct.pack("<12fH", 0, 0, 0, *np.concatenate([V[i] for i in f]), 0)
  bin_stl.write_bytes(bytes(raw))
  short = d / "two.obj"
  short.write_text("v 0 0 0\nv 1 0 0\n")
  return {"obj": obj, "ascii_stl": ascii_stl, "binary_stl": bin_stl, "too_few": short,
          "missing": d / "missing.stl", "other": d / "box.ply"}


def test_load_mesh_vertices_matches_jax(tmp_path):
  from raisimlib_tpu.models.urdf import load_mesh_vertices as jload
  from raisimlib_torch.models.urdf import load_mesh_vertices as tload

  files = _write_meshes(tmp_path)
  files["other"].write_text("ply\n")
  for name, path in files.items():
    vj, vt = jload(str(path)), tload(str(path))
    if name in ("too_few", "missing", "other"):
      assert vj is None and vt is None, name
      continue
    np.testing.assert_array_equal(vt, vj)
    assert vt.dtype == np.float64 and vt.shape[1] == 3
  V = _tetra_box()[0]
  np.testing.assert_allclose(np.unique(tload(str(files["binary_stl"])), axis=0),
                             np.unique(V.astype(np.float32).astype(np.float64), axis=0))


def test_urdf_mesh_geom_builds_the_same_scene(tmp_path):
  """A two-link arm whose forearm's collision is the OBJ box (scaled), over
  the ground: the same model, geom tables (the hull rows included) and
  pairs in both packages."""
  from torch_port_util import flatten_jax_scene

  from raisimlib_tpu.models.urdf import load_urdf as jurdf
  from raisimlib_tpu.world import World as JWorld
  from raisimlib_torch.models.urdf import load_urdf as turdf
  from raisimlib_torch.world import World as TWorld

  path = _write_meshes(tmp_path)["obj"]
  urdf = f"""<robot name="arm">
  <link name="base"><inertial><mass value="2.0"/><inertia ixx="0.02" iyy="0.02" izz="0.02"
    ixy="0" ixz="0" iyz="0"/></inertial>
    <collision><geometry><sphere radius="0.08"/></geometry></collision></link>
  <link name="forearm"><inertial><origin xyz="0.1 0 0"/><mass value="1.0"/>
    <inertia ixx="0.01" iyy="0.01" izz="0.01" ixy="0" ixz="0" iyz="0"/></inertial>
    <collision><origin xyz="0.2 0 0" rpy="0 0.3 0"/>
      <geometry><mesh filename="{path}" scale="1.5 1 2"/></geometry></collision></link>
  <joint name="elbow" type="revolute"><parent link="base"/><child link="forearm"/>
    <origin xyz="0 0 0.1"/><axis xyz="0 1 0"/></joint>
</robot>"""
  jb, jg, jm = jurdf(urdf)
  tb, tg, tm = turdf(urdf)
  assert tm == jm and len(tg) == len(jg) == 2
  np.testing.assert_array_equal(tg[1]["mesh"], jg[1]["mesh"])
  jw, tw = JWorld(dt=0.002, dtype=jnp.float64), TWorld(dt=0.002, dtype=torch.float64,
                                                        device="cpu")
  for w, b, g in ((jw, jb, jg), (tw, tb, tg)):
    w.add_articulated_system(b, name="arm", geoms=g)
    w.add_ground()
  js, ts = jw.compile(), tw.compile()
  arrays, static = flatten_jax_scene(js)
  for f in MODEL_FIELDS:
    np.testing.assert_allclose(getattr(ts.model, f).numpy(), arrays[f], rtol=0, atol=1e-12)
  np.testing.assert_allclose(ts.geoms.params.numpy(), arrays["geom_params"], atol=1e-12)
  np.testing.assert_allclose(ts.geoms.mesh_verts.numpy(), arrays["geom_mesh_verts"], atol=1e-12)
  assert tuple(ts.geoms.gtype) == tuple(static["gtype"])
  assert tuple(ts.geoms.mesh_vcount) == tuple(static["geom_mesh_vcount"])
  assert ts.pairs == static["pairs"]
