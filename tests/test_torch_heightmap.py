"""The port's terrain generator and heightmap narrow phase against the JAX
package (raisimlib_tpu/utils/terrain.py, raisimlib_tpu/ops/heightmap.py).

  * The value noise upsamples the lattice that JAX draws for key 11 to the
    field `terrain.generate` gives, within 1e-6 in float32.
  * surface_at, _point_contact (r = 0, and r > 0 with the riser march) and
    collide_heightmap (sphere, capsule, box) agree with JAX in float64 on a
    random field and on a stairs field, both with cells steeper than the
    march's 0.77 gate: only float64 rounding separates them (1e-12 for the
    surface and point functions; 1e-10 for the geoms, whose poses come out
    of forward kinematics).

Inputs come from numpy seeds. JAX runs eagerly on the CPU (`vmap` without
`jit`): each primitive is then rounded on its own, as in PyTorch, while a
jitted graph may fuse and contract differently, which flips the march's
first-match choice between samples on one triangle plane (an exact tie in
real arithmetic)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import flatten_jax_scene
from torch_port_util import one_thread  # noqa: F401  (a module fixture)

from raisimlib_tpu.models.model import JointType
from raisimlib_tpu.ops import collision as jcoll
from raisimlib_tpu.ops import dynamics as jdyn
from raisimlib_tpu.ops import heightmap as jhm
from raisimlib_tpu.utils import terrain as jterrain
from raisimlib_tpu.world import World as JWorld

TRAIN = dict(z_scale=0.06, x_size=12.0, y_size=6.0, x_samples=48, y_samples=24)


def test_value_noise_matches_jax_lattice():
  """The lattices JAX draws for key 11, upsampled by the port, give
  terrain.generate's field (12 x 6 m, 48 x 24 samples, 3 octaves)."""
  from raisimlib_torch.utils import terrain

  key = jax.random.PRNGKey(11)
  props = jterrain.TerrainProperties(**TRAIN)
  ref = np.asarray(jterrain.generate(key, props, dtype=jnp.float32).heights)
  keys = jax.random.split(key, props.fractal_octaves)
  h = torch.zeros((48, 24))
  amp, freq = 0.5 * props.z_scale, props.frequency
  for o in range(props.fractal_octaves):
    cx = max(1, int(round(freq * props.x_size)))
    cy = max(1, int(round(freq * props.y_size)))
    lat = np.asarray(jax.random.uniform(keys[o], (cx + 1, cy + 1), jnp.float32, -1.0, 1.0))
    h = h + amp * terrain._value_noise_from_lattice(torch.tensor(lat), 48, 24, cx, cy)
    amp *= props.fractal_gain
    freq *= props.fractal_lacunarity
  np.testing.assert_allclose(h.numpy(), ref, atol=1e-6, rtol=0)


def test_generate_is_deterministic_in_its_generator():
  """The port draws its lattices from a torch.Generator: the same seed gives
  the same field, another seed another one, and the field stays within the
  octaves' summed amplitude."""
  from raisimlib_torch.utils import terrain

  props = terrain.TerrainProperties(**TRAIN)
  gen = lambda seed: terrain.generate(props, torch.Generator().manual_seed(seed),  # noqa: E731
                                      device="cpu").heights
  a, b, c = gen(11), gen(11), gen(12)
  assert a.shape == (48, 24) and torch.equal(a, b) and not torch.equal(a, c)
  assert float(a.abs().max()) <= 0.5 * 0.06 * (1 + 0.5 + 0.25)


# ---- the narrow phase, float64 ---------------------------------------------


def _fields():
  rng = np.random.RandomState(3)
  rough = jhm.HeightField(heights=jnp.asarray(rng.uniform(-0.25, 0.25, (17, 13))),
                          center=jnp.asarray([0.3, -0.2]), size_x=4.0, size_y=3.0)
  stairs = jterrain.stairs(0.45, 0.2, size=(4.0, 2.0), samples=(33, 9),
                           center=(-0.1, 0.05), dtype=jnp.float64)
  return {"rough": rough, "stairs": stairs}


def _port_field(jf):
  from raisimlib_torch.ops import heightmap as hm

  return hm.HeightField(heights=torch.tensor(np.asarray(jf.heights)),
                        center=torch.tensor(np.asarray(jf.center)),
                        size_x=jf.size_x, size_y=jf.size_y)


def _steepest_nz(jf):
  H = np.asarray(jf.heights)
  dx = jf.size_x / (H.shape[0] - 1)
  g = np.abs(np.diff(H, axis=0)).max() / dx
  return 1.0 / np.sqrt(1.0 + g * g)


def _points(jf, n=256, seed=0):
  """Points over the field and a margin beyond it, 0.15 m around the
  surface."""
  rng = np.random.RandomState(seed)
  c = np.asarray(jf.center)
  xy = c + (rng.rand(n, 2) - 0.5) * 1.1 * np.array([jf.size_x, jf.size_y])
  z = float(np.asarray(jf.heights).mean()) + rng.uniform(-0.15, 0.15, n)
  return np.concatenate([xy, z[:, None]], 1)


@pytest.mark.parametrize("kind", ["rough", "stairs"])
def test_surface_at_matches_jax(kind):
  from raisimlib_torch.ops import heightmap as hm

  jf = _fields()[kind]
  assert _steepest_nz(jf) < 0.77                  # the march's gate is met somewhere
  p = _points(jf)
  zj, nj, ij = jax.vmap(lambda xy: jhm.surface_at(jf, xy))(jnp.asarray(p[:, :2]))
  zt, nt, it = hm.surface_at(_port_field(jf), torch.tensor(p[:, :2]))
  np.testing.assert_allclose(zt.numpy(), np.asarray(zj), atol=1e-12, rtol=0)
  np.testing.assert_allclose(nt.numpy(), np.asarray(nj), atol=1e-12, rtol=0)
  np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
  assert 0 < it.numpy().mean() < 1


@pytest.mark.parametrize("kind", ["rough", "stairs"])
@pytest.mark.parametrize("r", [0.0, 0.12])
def test_point_contact_matches_jax(kind, r):
  """r = 0 is a box corner's single sample; r = 0.12 marches 16 samples."""
  from raisimlib_torch.ops import heightmap as hm

  jf = _fields()[kind]
  p = _points(jf, seed=1)
  outs_j = jax.vmap(lambda x: jhm._point_contact(jf, x, r))(jnp.asarray(p))
  outs_t = hm._point_contact(_port_field(jf), torch.tensor(p), r)
  for a, b in zip(outs_t[:3], outs_j[:3]):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-12, rtol=0)
  np.testing.assert_array_equal(outs_t[3].numpy(), np.asarray(outs_j[3]))
  assert 0 < outs_t[3].numpy().mean() < 1
  if r > 0:                                       # some march candidate won
    _, n0, _ = hm.surface_at(_port_field(jf), torch.tensor(p[:, :2]))
    assert (outs_t[1] - n0).abs().amax(-1).max() > 1e-3


def _geom_scene(jf):
  """A FREE body carrying a sphere, a tilted capsule and a box, over the
  field."""
  Rc = np.array([[0.0, 0.0, 1.0], [0.0, 1.0, 0.0], [-1.0, 0.0, 0.0]])
  world = JWorld(dt=0.002, dtype=jnp.float64)
  world.add_articulated_system(
      [dict(parent=-1, joint=JointType.FREE, mass=2.0, com=[0, 0, 0],
            inertia=0.05 * np.eye(3), name="carrier", actuated=False)],
      name="carrier",
      geoms=[dict(body=0, gtype=jcoll.GEOM_SPHERE, params=[0.09], offset_pos=[0.25, 0, 0]),
             dict(body=0, gtype=jcoll.GEOM_CAPSULE, params=[0.05, 0.12],
                  offset_pos=[-0.2, 0.05, 0], offset_rot=Rc),
             dict(body=0, gtype=jcoll.GEOM_BOX, params=[0.1, 0.07, 0.05],
                  offset_pos=[0, 0.18, 0.02])])
  world.add_heightmap(jf)
  return world.compile(joint_limits=False)


@pytest.mark.parametrize("kind", ["rough", "stairs"])
def test_collide_heightmap_matches_jax(kind):
  """Sphere (1 slot), capsule (2) and box (8) on 64 random poses."""
  from raisimlib_torch import convert
  from raisimlib_torch.ops import dynamics, heightmap as hm

  jf = _fields()[kind]
  js = _geom_scene(jf)
  ts = convert.scene_from_numpy(*flatten_jax_scene(js), device="cpu", dtype=torch.float64)
  rng = np.random.RandomState(4)
  B = 64
  q = np.zeros((B, 7))
  q[:, :3] = _points(jf, B, seed=2)
  quat = rng.randn(B, 4)
  q[:, 3:] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
  kin_t = dynamics.fk(ts.model, torch.tensor(q))
  for gi, t in enumerate(js.geoms.gtype):
    if t == jcoll.GEOM_HEIGHTMAP:
      continue
    fn = jax.vmap(lambda qq, gi=gi: jhm.collide_heightmap(
        js.geoms, gi, jdyn.fk(js.model, qq), js.field))
    slots_j = fn(jnp.asarray(q))
    slots_t = hm.collide_heightmap(ts.geoms, gi, kin_t, ts.field)
    assert len(slots_t) == len(slots_j) == {0: 1, 1: 8, 2: 2}[t]
    for st, sj in zip(slots_t, slots_j):
      for a, b in zip(st[:3], sj[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-10, rtol=0)
      np.testing.assert_array_equal(st[3].numpy(), np.asarray(sj[3]))
