"""The sphere pairs of the port's narrow phase against the JAX package's,
run eagerly (jax.disable_jit) on the same numpy poses, float64, at 1e-12:
`_sphere_sphere`, `_sphere_box` (outside, the interior branch, face ties and
a centre on a face plane), `_sphere_capsule`, against a body and against
static world geometry; `geom_aabb` and `broadphase_mask`; and the canonical
pair order of `candidate_pairs`."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raisimlib_tpu.ops import collision as jc
from raisimlib_torch.ops import collision as tc

from torch_port_util import one_thread  # noqa: F401  (a module fixture)

TOL = 1e-12     # f64: the same formulas, summed in another order at most


def _rot(axis, angle):
  a = np.asarray(axis, np.float64) / np.linalg.norm(axis)
  K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
  return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * K @ K


def _random_rot(rng):
  q = rng.standard_normal(4)
  w, x, y, z = q / np.linalg.norm(q)
  return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                   [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                   [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


HE = (0.25, 0.1875, 0.125)          # dyadic half extents: face ties are exact
SPECS = [
    tc.GeomSpec(0, tc.GEOM_SPHERE, np.array([0.08, 0, 0, 0.0]), np.zeros(3), np.eye(3), 0),
    tc.GeomSpec(1, tc.GEOM_SPHERE, np.array([0.05, 0, 0, 0.0]), np.array([0.01, 0.0, 0.02]),
                np.eye(3), 0),
    tc.GeomSpec(2, tc.GEOM_BOX, np.array(HE + (0.0,)), np.zeros(3), np.eye(3), 0),
    tc.GeomSpec(3, tc.GEOM_CAPSULE, np.array([0.06, 0.15, 0, 0.0]), np.array([0.0, 0.02, 0.0]),
                _rot([1, 0, 0], 0.4), 0),
    tc.GeomSpec(-1, tc.GEOM_BOX, np.array([0.3, 0.2, 0.1, 0.0]), np.array([0.5, 0.0, 0.1]),
                _rot([0, 0, 1], 0.3), 0),
    tc.GeomSpec(-1, tc.GEOM_SPHERE, np.array([0.1, 0, 0, 0.0]), np.array([-0.2, 0.1, 0.1]),
                np.eye(3), 0),
    tc.GeomSpec(-1, tc.GEOM_PLANE, np.array([0.01, 0, 0, 0.0]), np.zeros(3), np.eye(3), 0),
]
PAIRS = {"sphere-sphere": (0, 1), "sphere-box": (0, 2), "sphere-capsule": (0, 3),
         "sphere-static box": (0, 4), "static sphere-sphere": (5, 0)}

# sphere centres in the frame of the box (body 2 at the identity pose):
# the interior branch with a unique face, ties (first match x, then y), the
# centre, centres on a face plane (the sign is never 0) and outside points
BOX_FRAME_CENTRES = [(0.05, 0.02, 0.03), (0.125, 0.0625, 0.0), (0.0, 0.0625, 0.0),
                     (-0.125, 0.0, 0.0), (0.0, 0.0, 0.0), (0.25, 0.0, 0.0),
                     (0.0, 0.0, -0.125), (0.3, 0.2, 0.0), (0.0, -0.25, 0.1)]


@pytest.fixture(scope="module")
def poses():
  """(R (B, 4, 3, 3), p (B, 4, 3)) of the 4 bodies: 64 random worlds with
  the bodies close enough to touch in some, then the box-frame cases."""
  rng = np.random.default_rng(0)
  nr, nh = 64, len(BOX_FRAME_CENTRES)
  R = np.stack([[_random_rot(rng) for _ in range(4)] for _ in range(nr + nh)])
  p = 0.2 * rng.standard_normal((nr + nh, 4, 3))
  p[:, 1] = p[:, 0] + 0.08 * rng.standard_normal((nr + nh, 3))
  p[nr:, 2] = 0.0
  R[nr:, 2] = np.eye(3)
  p[nr:, 0] = BOX_FRAME_CENTRES
  return R, p


def _tables(dtype=torch.float64):
  return jc.build_geom_table(SPECS, dtype=jnp.float64), tc.build_geom_table(
      SPECS, dtype=dtype, device="cpu")


def _jax_per_world(fn, R, p):
  """fn(kin) of one world, JAX eager (no jit, so no fusion), vmapped over
  the worlds."""
  with jax.disable_jit():
    out = jax.vmap(lambda r, x: fn(types.SimpleNamespace(R=r, p=x)))(jnp.asarray(R),
                                                                       jnp.asarray(p))
  return jax.tree_util.tree_map(np.asarray, out)


@pytest.mark.parametrize("name", list(PAIRS))
def test_sphere_pairs_match_jax_eager(poses, name):
  R, p = poses
  ia, ib = PAIRS[name]
  gj, gt = _tables()
  kind = {tc.GEOM_SPHERE: "sphere", tc.GEOM_BOX: "box", tc.GEOM_CAPSULE: "capsule"}
  fname = f"_sphere_{kind[gt.gtype[ib]]}"
  ref = _jax_per_world(lambda kin: getattr(jc, fname)(gj, ia, ib, kin)[0], R, p)
  kin = types.SimpleNamespace(R=torch.tensor(R), p=torch.tensor(p))
  (out,) = getattr(tc, fname)(gt, ia, ib, kin)
  for k, f in enumerate(("pos", "normal", "depth")):
    np.testing.assert_allclose(out[k].numpy(), ref[k], rtol=0, atol=TOL, err_msg=f)
  assert np.array_equal(out[3].numpy(), ref[3])
  active = float(out[3].double().mean())
  assert 0.0 < active < 1.0, active              # both sides of the contact
  if name == "sphere-box":                       # the box-frame cases
    n = out[1].numpy()[-len(BOX_FRAME_CENTRES):]
    np.testing.assert_array_equal(n[:7], [[0, 0, 1], [1, 0, 0], [0, 1, 0], [-1, 0, 0],
                                          [0, 0, 1], [1, 0, 0], [0, 0, -1]])


def test_aabb_and_broadphase_match_jax_eager(poses):
  R, p = poses
  gj, gt = _tables()
  kin = types.SimpleNamespace(R=torch.tensor(R), p=torch.tensor(p))
  for gi in range(len(SPECS)):
    lo, hi = tc.geom_aabb(gt, gi, kin)
    ref = _jax_per_world(lambda k: jc.geom_aabb(gj, gi, k), R, p)
    np.testing.assert_allclose(lo.numpy(), ref[0], rtol=0, atol=TOL)
    np.testing.assert_allclose(hi.numpy(), ref[1], rtol=0, atol=TOL)
  pairs = tuple(PAIRS.values()) + ((0, 6), (2, 6))
  masks = tc.broadphase_mask(gt, pairs, kin)
  ref = _jax_per_world(lambda k: jc.broadphase_mask(gj, pairs[:-2], k), R, p)
  assert masks[-2:] == [True, True]              # against the plane: no operation
  for m, r in zip(masks[:-2], ref):
    assert np.array_equal(m.numpy(), r) and 0 < r.sum() < len(r)


def _world(pkg, static=False):
  """Ground, box (static or not), sphere: the stack's geom order."""
  if pkg == "jax":
    from raisimlib_tpu.world import World
    w = World(dt=0.002, dtype=jnp.float64)
  else:
    from raisimlib_torch.world import World
    w = World(dt=0.002, dtype=torch.float64, device="cpu")
  w.add_ground()
  w.add_box((0.25, 0.25, 0.15), 2.0, pos=(0.0, 0.0, 0.151), static=static,
            rot=_rot([0, 0, 1], 0.3) if static else None)
  w.add_sphere(0.12, 1.0, pos=(0.05, 0.0, 0.45))
  return w


@pytest.mark.parametrize("static", [False, True])
def test_pair_order_puts_the_sphere_first(static):
  """Ground, box, sphere: the box-sphere pair comes out (sphere, box), as
  the JAX package orders it and the "sb" slot assumes; a static box never
  pairs with the ground."""
  st, sj = _world("torch", static).compile(), _world("jax", static).compile()
  assert st.pairs == sj.pairs == (((2, 0), (2, 1)) if static else ((1, 0), (2, 0), (2, 1)))
  assert st.geoms.body[1] == (-1 if static else 0)


def test_collide_gates_sphere_pairs_by_the_broadphase():
  """collide on the stack matches the JAX package's collide (grouped plane
  pairs, the sphere-box pair on its own, the AABB mask ANDed into active).
  Jitted JAX here: no pose of this test lies on a first-match tie."""
  from raisimlib_tpu.ops import dynamics as jd
  from raisimlib_torch.ops import dynamics as td

  st, sj = _world("torch").compile(), _world("jax").compile()
  rng = np.random.default_rng(1)
  B = 8
  q = np.tile(np.asarray(sj.model.q_init), (B, 1))
  q[:, [0, 1, 7, 8]] += 0.4 * rng.standard_normal((B, 4))
  q[:, [2, 9]] += 0.05 * rng.standard_normal((B, 2))
  cj = jax.jit(jax.vmap(lambda x: jc.collide(sj.geoms, sj.pairs, jd.fk(sj.model, x))))(
      jnp.asarray(q))
  ct = tc.collide(st.geoms, st.pairs, td.fk(st.model, torch.tensor(q)))
  for f in ("pos", "normal", "depth", "active"):
    np.testing.assert_allclose(getattr(ct, f).numpy(), np.asarray(getattr(cj, f)),
                               rtol=0, atol=TOL, err_msg=f)
  assert ct.body_a == cj.body_a and ct.body_b == cj.body_b
  assert 0.0 < float(ct.active[:, -1].mean()) < 1.0      # the sphere-box slot
