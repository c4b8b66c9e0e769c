"""The narrow phases of the pairs of two bounded geoms, in the port against
the JAX package, in float64 on 16 seeded random poses:

  * box-box (the 15-axis separating-axis test, 9 slots), capsule-capsule,
    sphere-cylinder, sphere-mesh and the support-function kernel of every
    other convex pair (4 slots), as `collide` computes them (all pairs of a
    type at once, the broad phase's mask in `active`), against the JAX
    package's per-pair kernels under vmap with its broadphase_mask, to 1e-9
    on pos, normal and depth, and equal `active`;
  * support_points of every bounded geom type, and geom_aabb of the
    cylinder, cone and mesh (a static box's too), to 1e-9;
  * candidate_pairs and num_contact_slots on a scene holding every geom
    type, built through both packages' World calls.

Box-box where B's face is the reference (slots 4-7) is held instead to
the A-reference slots of the JAX package's box-box of the pair turned round
(B, A), with the normal turned back: the JAX package's own B-reference
slots are wrong (it passes B's centre in B's frame where A's belongs, so
the normal points A -> B and the points sit on B's far face; a box resting
on a smaller box sinks through it), and the port's are right.

Near-ties. The branches of box-box follow the comparisons of its SAT depths
(which axis is least, face against edge by a 5% bias, A's face against
B's). A world where one of those comparisons is decided by less than 1e-9
in the JAX package's own float64 depths could go either way in the port's
rounding: the rule below (`_box_box_ties`) lists such worlds and leaves
them out; the seeded poses have none. The support-function kernel's
argmins have no such rule: its outputs agree to rounding on every pose
here.

Every JAX call is a pure function (no Pallas kernel lies on the collision
path), run eagerly under vmap."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import load_chip_smoke, port_scene
from torch_port_util import one_thread  # noqa: F401  (a module fixture)

from raisimlib_tpu.ops import collision as jcoll
from raisimlib_tpu.ops import dynamics as jdyn
from raisimlib_tpu.world import World as JWorld

B = 16
TOL = 1e-9
CS = load_chip_smoke()
S, BX, C, P, H, CY, M, CO = (jcoll.GEOM_SPHERE, jcoll.GEOM_BOX, jcoll.GEOM_CAPSULE,
                             jcoll.GEOM_PLANE, jcoll.GEOM_HEIGHTMAP, jcoll.GEOM_CYLINDER,
                             jcoll.GEOM_MESH, jcoll.GEOM_CONE)
# every key of the pair table between two bounded geoms
BOUNDED_KEYS = sorted(k for k in jcoll._PAIR_SLOTS if P not in k and H not in k)
KERNELS = {(BX, BX): jcoll._box_box, (C, C): jcoll._capsule_capsule,
           (S, CY): jcoll._sphere_cylinder, (S, M): jcoll._sphere_mesh,
           (S, S): jcoll._sphere_sphere, (S, BX): jcoll._sphere_box,
           (S, C): jcoll._sphere_capsule}


def _add_all(w):
  """Two of each bounded geom type (the rock as the mesh), a static box
  and the ground."""
  w.add_ground()
  for _ in range(2):
    w.add_sphere(0.1, 1.0, pos=(0.0, 0.0, 0.5))
    w.add_box((0.15, 0.1, 0.08), 1.0, pos=(0.0, 0.0, 0.5))
    w.add_capsule(0.07, 0.15, 1.0, pos=(0.0, 0.0, 0.5))
    w.add_cylinder(0.08, 0.12, 1.0, pos=(0.0, 0.0, 0.5))
    w.add_cone(0.1, 0.25, 1.0, pos=(0.0, 0.0, 0.5))
    w.add_mesh(CS.rock_vertices(), 1.0, pos=(0.0, 0.0, 0.5))
  w.add_box((0.5, 0.5, 0.2), 1.0, pos=(0.0, 0.0, 0.2), static=True)


@pytest.fixture(scope="module")
def scenes():
  """The scene in both packages, 16 random poses (positions within 0.25 m
  of a point 0.45 m over the ground, uniform orientations), the JAX
  package's FK of each, and the port's ContactSet."""
  from raisimlib_torch.ops import collision as coll
  from raisimlib_torch.ops import dynamics

  w = JWorld(dt=0.002, dtype=jnp.float64)
  _add_all(w)
  js = w.compile(joint_limits=False)
  ts = port_scene(js)
  rng = np.random.RandomState(0)
  q = np.zeros((B, js.model.nq))
  for b in range(js.model.nb):
    q[:, 7 * b:7 * b + 3] = rng.uniform(-0.25, 0.25, (B, 3)) + np.array([0.0, 0.0, 0.45])
    quat = rng.randn(B, 4)
    q[:, 7 * b + 3:7 * b + 7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
  kin_j = jax.vmap(lambda qq: jdyn.fk(js.model, qq))(jnp.asarray(q))
  kin_t = dynamics.fk(ts.model, torch.tensor(q))
  return js, ts, kin_j, kin_t, coll.collide(ts.geoms, ts.pairs, kin_t)


def _busiest_pair(js, key, active):
  """(ia, ib, first slot) of the scene's pair of `key` whose slots are
  active in the most worlds (the port's `active`, B x nc)."""
  slot, best = 0, None
  for ia, ib in js.pairs:
    k = (js.geoms.gtype[ia], js.geoms.gtype[ib])
    ns = jcoll._PAIR_SLOTS[tuple(sorted(k))]
    if k == key:
      n = int(active[:, slot:slot + ns].amax(1).sum())
      if best is None or n > best[0]:
        best = (n, ia, ib, slot)
    slot += ns
  assert best is not None, f"no pair {key}"
  return best[1:]


def _box_box_ties(js, ia, ib, kin_j):
  """Worlds in which a decision of box-box is within 1e-9 in the JAX
  package's float64 SAT depths: the least axis of A's faces, of B's faces
  or of the edges (against the runner-up), face against edge (5% bias),
  A's face against B's."""
  def depths(k):
    Ra, pa = jcoll._geom_pose(js.geoms, ia, k)
    Rb, pb = jcoll._geom_pose(js.geoms, ib, k)
    ea, eb = js.geoms.params[ia, :3], js.geoms.params[ib, :3]
    Rab, tab = Ra.T @ Rb, Ra.T @ (pb - pa)
    Cabs = jnp.abs(Rab) + 1e-7
    dA = (ea + Cabs @ eb) - jnp.abs(tab)
    dB = (eb + Cabs.T @ ea) - jnp.abs(Rab.T @ tab)
    de = []
    for i in range(3):
      for j in range(3):
        ax = jnp.cross(jnp.eye(3)[i], Rab[:, j])
        n2 = jnp.sum(ax * ax)
        axu = ax * jax.lax.rsqrt(jnp.maximum(n2, 1e-12))
        d = (jnp.sum(ea * jnp.abs(axu)) + jnp.sum(eb * jnp.abs(axu @ Rab))
             - jnp.abs(jnp.dot(axu, tab)))
        de.append(jnp.where(n2 > 1e-8, d, 3e38))
    return dA, dB, jnp.stack(de)

  dA, dB, dE = (np.asarray(x) for x in jax.vmap(depths)(kin_j))

  def gap2(x):
    s = np.sort(x, axis=1)
    return s[:, 1] - s[:, 0]

  bA, bB, bE = dA.min(1), dB.min(1), dE.min(1)
  gaps = np.stack([gap2(dA), gap2(dB), gap2(dE), np.abs(bA - bB),
                   np.abs(np.minimum(bA, bB) - (bE * 1.05 + 1e-9))], 1)
  return np.nonzero(gaps.min(1) < 1e-9)[0].tolist()


NAMES = {S: "sphere", BX: "box", C: "capsule", CY: "cylinder", M: "mesh", CO: "cone"}


@pytest.mark.parametrize("key", BOUNDED_KEYS,
                         ids=[f"{NAMES[a]}-{NAMES[b]}" for a, b in BOUNDED_KEYS])
def test_pair_matches_jax(key, scenes):
  """The port's slots of the scene's pair of this type that touches in
  the most worlds (collide, grouped with the other pairs of its type)
  against the JAX package's kernel under vmap, ANDed with its broad
  phase."""
  js, ts, kin_j, kin_t, ct = scenes
  ia, ib, slot = _busiest_pair(js, key, ct.active)
  fn = KERNELS.get(key, jcoll._support_pair)
  out = jax.vmap(lambda k: fn(js.geoms, ia, ib, k))(kin_j)
  if key == (BX, BX):                    # B's reference slots: A's of (B, A), turned
    turned = jax.vmap(lambda k: fn(js.geoms, ib, ia, k))(kin_j)
    out = list(out[:4]) + [(p, -n, d, v) for p, n, d, v in turned[:4]] + [out[8]]
  near = np.asarray(jax.vmap(lambda k: jnp.asarray(
      jcoll.broadphase_mask(js.geoms, [(ia, ib)], k)[0]))(kin_j))
  worlds = np.arange(B)
  if key == (BX, BX):
    ties = _box_box_ties(js, ia, ib, kin_j)
    assert len(ties) <= 2, f"near-tied worlds {ties}"
    worlds = np.setdiff1d(worlds, ties)
  assert near.any() and (~near).any() or key == (BX, BX), "the poses should test the mask"
  for si, (pos, n, d, v) in enumerate(out):
    k = slot + si
    for name, ref, got in (("pos", pos, ct.pos[:, k]), ("normal", n, ct.normal[:, k]),
                           ("depth", d, ct.depth[:, k])):
      err = np.abs(np.asarray(ref) - got.numpy())[worlds].max()
      assert err <= TOL, f"slot {si} {name}: {err:.2e}"
    act = (np.asarray(v) & near).astype(np.float64)
    np.testing.assert_array_equal(ct.active[:, k].numpy()[worlds], act[worlds])
  assert float(ct.active[:, slot:slot + len(out)].sum()) > 0.0, "no slot of the pair touches"


def test_box_resting_on_a_smaller_box():
  """A box (B) resting 1 cm deep on a smaller box (A) below it: B's face is
  the reference (the least penetrated, by 1e-7 of the axes' sums), and the
  4 slots lie on the interface, 1 cm deep, with the normal B -> A (down),
  as for a smaller box on a larger one (A's face the reference). The JAX
  package gives the normal up and the points on B's top face here."""
  from raisimlib_torch.ops import collision as coll
  from raisimlib_torch.ops import dynamics
  from raisimlib_torch.world import World

  for he_top, face in (((0.12, 0.13, 0.12), slice(4, 8)), ((0.10, 0.09, 0.10), slice(0, 4))):
    w = World(dt=0.002, dtype=torch.float64, device="cpu")
    w.add_box((0.11, 0.10, 0.13), 1.0, pos=(0.0, 0.0, 0.13))
    w.add_box(he_top, 1.0, pos=(0.0, 0.0, 0.26 + he_top[2] - 0.01))
    sc = w.compile(joint_limits=False)
    c = coll.collide(sc.geoms, sc.pairs, dynamics.fk(sc.model, sc.model.q_init[None]))
    act = c.active[0].numpy()
    assert act[face].all() and act.sum() == 4
    np.testing.assert_allclose(c.normal[0, face].numpy(), [[0.0, 0.0, -1.0]] * 4, atol=1e-12)
    np.testing.assert_allclose(c.depth[0, face].numpy(), 0.01, atol=1e-12)
    np.testing.assert_allclose(c.pos[0, face, 2].numpy(), 0.255, atol=1e-12)


@pytest.mark.parametrize("gi", [0, 1, 2, 3, 4, 5], ids=["sphere", "box", "capsule", "cylinder",
                                                       "cone", "mesh"])
def test_support_points_match_jax(gi, scenes):
  """support_points of each bounded geom type along 24 random unit
  directions (and the 6 axes) in every world."""
  from raisimlib_torch.ops import collision as coll

  js, ts, kin_j, kin_t, _ = scenes
  g = gi + 1                                           # geom 0 is the ground
  rng = np.random.RandomState(gi)
  D = rng.randn(24, 3)
  D = np.concatenate([D / np.linalg.norm(D, axis=1, keepdims=True), np.eye(3), -np.eye(3)])
  ref = np.asarray(jax.vmap(lambda k: jcoll.support_points(js.geoms, g, k, jnp.asarray(D)))(kin_j))
  side = coll._side(ts.geoms, [g], kin_t)
  got = coll.support_points(side, torch.tensor(D).expand(B, 1, -1, -1))[:, 0].numpy()
  np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)


@pytest.mark.parametrize("gi", [4, 5, 6, 13], ids=["cylinder", "cone", "mesh", "static_box"])
def test_geom_aabb_matches_jax(gi, scenes):
  from raisimlib_torch.ops import collision as coll

  js, ts, kin_j, kin_t, _ = scenes
  lo, hi = coll.geom_aabb(ts.geoms, gi, kin_t)
  lo_j, hi_j = jax.vmap(lambda k: jcoll.geom_aabb(js.geoms, gi, k))(kin_j)
  lo_j, hi_j = np.broadcast_to(lo_j, lo.shape), np.broadcast_to(hi_j, hi.shape)
  np.testing.assert_allclose(lo.numpy(), lo_j, rtol=0, atol=TOL)
  np.testing.assert_allclose(hi.numpy(), hi_j, rtol=0, atol=TOL)


def test_broadphase_margin_matches_jax(scenes):
  """broadphase_mask(margin=0.05) over every pair of the scene."""
  from raisimlib_torch.ops import collision as coll

  js, ts, kin_j, kin_t, _ = scenes
  got = coll.broadphase_mask(ts.geoms, ts.pairs, kin_t, margin=0.05)
  ref = jax.vmap(lambda k: [jnp.asarray(m) for m in
                            jcoll.broadphase_mask(js.geoms, js.pairs, k, margin=0.05)])(kin_j)
  assert sum(m is True for m in got) == 12             # the ground's pairs
  for g, r in zip(got, ref):
    r = np.asarray(r)
    np.testing.assert_array_equal(np.broadcast_to(np.asarray(g), (B,)), np.broadcast_to(r, (B,)))


def test_candidate_pairs_of_every_geom_type():
  """A world holding every geom type (a heightmap too), built by the same
  calls in both packages: the same pairs in the same canonical order, the
  same slot count, and no pair type left out."""
  from raisimlib_tpu.ops import heightmap as jhm
  from raisimlib_torch.ops import collision as coll
  from raisimlib_torch.ops import heightmap as hm
  from raisimlib_torch.world import World

  scenes = []
  for W, kw, field in ((JWorld, dict(dtype=jnp.float64),
                        jhm.HeightField(heights=jnp.zeros((5, 5)), center=jnp.zeros(2),
                                        size_x=2.0, size_y=2.0)),
                       (World, dict(dtype=torch.float64, device="cpu"),
                        hm.HeightField(heights=torch.zeros(5, 5, dtype=torch.float64),
                                       center=torch.zeros(2, dtype=torch.float64),
                                       size_x=2.0, size_y=2.0))):
    w = W(dt=0.002, **kw)
    _add_all(w)
    w.add_heightmap(field)
    scenes.append(w.compile(joint_limits=False))
  js, ts = scenes
  assert ts.pairs == js.pairs
  n = coll.num_contact_slots(ts.geoms, ts.pairs)
  assert n == jcoll.num_contact_slots(js.geoms, js.pairs)
  keys = {tuple(sorted((ts.geoms.gtype[a], ts.geoms.gtype[b]))) for a, b in ts.pairs}
  assert keys == set(jcoll._PAIR_SLOTS), set(jcoll._PAIR_SLOTS) ^ keys
