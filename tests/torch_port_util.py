"""Shared helpers of the port's parity tests (tests/test_torch_*.py): build
the ANYmal main-path scene in both packages, flatten a JAX Scene into the
numpy arrays + plain-Python static data that raisimlib_torch.convert takes,
and build the fused step's generated body as host C++.
JAX is imported only inside the JAX-side helpers, so that the card's tests
(tests/test_torch_cuda.py) run where JAX is not installed."""

import os

import numpy as np
import pytest
import torch

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
MODEL_FIELDS = ("X_rot", "X_pos", "axis", "inertia", "mass", "actuated",
                "torque_limit", "joint_lo", "joint_hi", "q_init")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
  """One intra-op torch thread for the test module that imports this
  fixture: the port's tests run a few worlds at a time, and the test
  workers share the machine's cores."""
  n = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(n)


def load_golden(name="anymal_balance.npz"):
  return np.load(os.path.join(GOLDEN_DIR, name))


def jax_anymal_scene(dtype=None, dt=0.0025, kp=100.0, kd=2.0):
  import jax.numpy as jnp
  from raisimlib_tpu.models import anymal
  from raisimlib_tpu.models.urdf import load_urdf
  from raisimlib_tpu.world import World

  bodies, geoms, _ = load_urdf(anymal.anymal_urdf())
  world = World(dt=dt, dtype=jnp.float64 if dtype is None else dtype)
  world.add_articulated_system(bodies, name="anymal", geoms=geoms)
  world.add_ground()
  return world.compile().set_pd_gains(kp, kd)


def torch_anymal_scene(dtype=torch.float64, dt=0.0025, kp=100.0, kd=2.0, device="cpu"):
  from raisimlib_torch.models import anymal
  from raisimlib_torch.models.urdf import load_urdf
  from raisimlib_torch.world import World

  bodies, geoms, _ = load_urdf(anymal.anymal_urdf())
  world = World(dt=dt, dtype=dtype, device=device)
  world.add_articulated_system(bodies, name="anymal", geoms=geoms)
  world.add_ground()
  return world.compile().set_pd_gains(kp, kd)


def flatten_jax_scene(scene):
  """JAX Scene -> (arrays, static) for raisimlib_torch.convert.scene_from_numpy."""
  m, g = scene.model, scene.geoms
  arrays = {f: np.asarray(getattr(m, f)) for f in MODEL_FIELDS}
  arrays.update(geom_params=np.asarray(g.params),
                geom_offset_pos=np.asarray(g.offset_pos),
                geom_offset_rot=np.asarray(g.offset_rot),
                geom_mesh_verts=np.asarray(g.mesh_verts),
                materials=np.asarray(scene.materials),
                gravity=np.asarray(scene.gravity),
                kp=np.asarray(scene.kp), kd=np.asarray(scene.kd))
  static = dict(name=m.name, parent=m.parent, joint_types=m.joint_types,
                q_adr=m.q_adr, v_adr=m.v_adr, nq=m.nq, nv=m.nv,
                body_names=m.body_names, gtype=g.gtype, geom_body=g.body,
                geom_material=g.material, geom_mesh_vcount=g.mesh_vcount,
                pairs=scene.pairs,
                constraints=tuple(scene.constraints), dt=scene.dt,
                objects=scene.objects)
  if getattr(scene, "field", None) is not None:
    arrays.update(field_heights=np.asarray(scene.field.heights),
                  field_center=np.asarray(scene.field.center))
    static.update(field_size=(scene.field.size_x, scene.field.size_y))
  return arrays, static


def jax_record_keys(name):
  """The keys of the `result = {...}` record of examples/<name>.py."""
  import ast

  path = os.path.join(os.path.dirname(os.path.dirname(GOLDEN_DIR)), "examples", f"{name}.py")
  tree = ast.parse(open(path).read())
  for node in ast.walk(tree):
    if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
        and any(isinstance(t, ast.Name) and t.id == "result" for t in node.targets)):
      return {k.value for k in node.value.keys}
  raise AssertionError(f"no result record in examples/{name}.py")


def load_chip_smoke():
  """chip_smoke.py as a module (its scene builders and constants)."""
  import importlib.util

  path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "chip_smoke.py")
  spec = importlib.util.spec_from_file_location("chip_smoke", path)
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod


# the debris scenes of the CPU tests: a 2.4 x 2.0 m field of 13 x 11 samples
# and one of chip_smoke.py's debris bodies
DEBRIS_FIELD = dict(shape=(13, 11), center=(0.1, -0.05), size=(2.4, 2.0))


def jax_debris_scene(name, heights=None, ground=False):
  """A JAX float64 world with the debris field (zero heights unless given),
  the ground plane at z = -0.02 if `ground`, and debris body `name`."""
  import jax.numpy as jnp
  from raisimlib_tpu.ops import heightmap as jhm
  from raisimlib_tpu.world import World

  f = DEBRIS_FIELD
  world = World(dt=0.002, dtype=jnp.float64)
  if ground:
    world.add_ground(-0.02)
  world.add_heightmap(jhm.HeightField(
      heights=jnp.asarray(np.zeros(f["shape"]) if heights is None else heights),
      center=jnp.asarray(f["center"]), size_x=f["size"][0], size_y=f["size"][1]))
  load_chip_smoke().add_debris(world, name)
  return world.compile(joint_limits=False)


def port_scene(jscene, dtype=torch.float64):
  """The port's Scene of a JAX scene, on the CPU (convert.scene_from_numpy)."""
  from raisimlib_torch import convert

  return convert.scene_from_numpy(*flatten_jax_scene(jscene), device="cpu", dtype=dtype)


def debris_drop_states(scene, n, seed):
  """n per-world random terrains (+-5 cm) of the debris field and n debris
  bodies over them, tilted, spinning slowly and falling at 1 m/s, each with
  its deepest probe 1-3 mm above its terrain (placed by the port's narrow
  phase): (heights, q, u) as float64 numpy."""
  from raisimlib_torch.ops import collision as coll
  from raisimlib_torch.ops import dynamics

  f = DEBRIS_FIELD
  rng = np.random.RandomState(seed)
  hts = rng.uniform(-0.05, 0.05, (n,) + f["shape"])
  q = np.zeros((n, 7))
  q[:, 0] = f["center"][0] + rng.uniform(-0.6, 0.6, n)
  q[:, 1] = f["center"][1] + rng.uniform(-0.5, 0.5, n)
  quat = np.array([1.0, 0.0, 0.0, 0.0]) + 0.3 * rng.randn(n, 4)
  q[:, 3:] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
  q[:, 2] = 0.5
  c = coll.collide(scene.geoms, scene.pairs, dynamics.fk(scene.model, torch.tensor(q)),
                   scene.field.replace(heights=torch.tensor(hts)))
  q[:, 2] += c.depth.amax(1).numpy() + rng.uniform(0.001, 0.003, n)
  u = 0.1 * rng.randn(n, 6)
  u[:, 5] = -1.0
  return hts, q, u


def debris_max_depth(scene, q, hts):
  """The deepest active contact over the worlds (q, per-world heights)."""
  from raisimlib_torch.ops import collision as coll
  from raisimlib_torch.ops import dynamics

  c = coll.collide(scene.geoms, scene.pairs, dynamics.fk(scene.model, q),
                   scene.field.replace(heights=hts))
  return float((c.depth * c.active).max())


def jax_debris_rollout(jscene, hts, q, u, steps):
  """`steps` of JAX's step_batch(use_kernel=False) (jitted, float64) from
  (q, u) on per-world heights hts: the final (q, u) as numpy."""
  import jax
  import jax.numpy as jnp
  from raisimlib_tpu.ops import pipeline as jp
  from raisimlib_tpu.ops.integrator import State as JState

  n, nv = u.shape
  h = jnp.asarray(hts)

  def roll(s):
    step = lambda s, _: (jp.step_batch(jscene, s, jnp.zeros((n, nv)), None,  # noqa: E731
                                       field_heights=h, use_kernel=False), None)
    return jax.lax.scan(step, s, None, length=steps)[0]

  s = jax.jit(roll)(JState(q=jnp.asarray(q), u=jnp.asarray(u), t=jnp.zeros(n)))
  return np.asarray(s.q), np.asarray(s.u)


def host_matches_twin(sd, host, q, u, pd, heights=None, median_du=1e-6):
  """The host-compiled body and the twin on the same worlds: the card's two
  tiers (99% of worlds within 2e-5 on q and 2e-4 on u, all within 5e-4 and
  5e-3), and the median world within `median_du` on u."""
  from raisimlib_torch.ops import gpu_step

  B = q.shape[0]
  ins = [np.ascontiguousarray(x, np.float32) for x in (q, u, np.zeros_like(pd), pd)]
  hts = None if heights is None else np.ascontiguousarray(heights, np.float32)
  qo, uo = np.zeros_like(ins[0]), np.zeros_like(ins[1])
  host(*(x.ctypes.data for x in ins), None if hts is None else hts.ctypes.data,
       0 if hts is None else hts[0].size, qo.ctypes.data, uo.ctypes.data, B)
  with torch.inference_mode():
    qp, up = gpu_step._fused_plain(sd, *(torch.tensor(x) for x in ins),
                                   heights=None if hts is None else torch.tensor(hts))
  dq = np.abs(qo - qp.numpy()).max(1)
  du = np.abs(uo - up.numpy()).max(1)
  assert ((dq <= 2e-5) & (du <= 2e-4)).mean() >= 0.99
  assert dq.max() <= 5e-4 and du.max() <= 5e-3
  assert np.median(du) <= median_du


def perturbed_states(g, B, seed, dq=1e-3, du=1e-2):
  """B states around the golden's SETTLED q0/u0 (never raw standing_q, a knife
  edge where a 1e-7 change flips a contact branch), quaternion renormalised."""
  rng = np.random.default_rng(seed)
  q = np.tile(g["q0"], (B, 1)) + dq * rng.standard_normal((B, g["q0"].size))
  q[:, 3:7] /= np.linalg.norm(q[:, 3:7], axis=1, keepdims=True)
  u = np.tile(g["u0"], (B, 1)) + du * rng.standard_normal((B, g["u0"].size))
  return q, u


def anymal_factors(B, seed=0):
  """The main path's solver inputs (12 cone + 12 lin rows, nv = 18) from
  perturbed settled ANYmal states, as float32 numpy, and the row kinds."""
  from raisimlib_torch.ops import pipeline
  from raisimlib_torch.ops.integrator import State

  g = load_golden()
  scene = torch_anymal_scene()
  q, u = perturbed_states(g, B, seed)
  state = State(q=torch.tensor(q), u=torch.tensor(u), t=torch.zeros(B, dtype=torch.float64))
  tgt = torch.tensor(np.tile(g["pd_targets"][0], (B, 1)))
  with torch.inference_mode():
    args, cfg = pipeline.solver_inputs(scene, state, torch.zeros_like(tgt), tgt)
  return [a.numpy().astype(np.float32) for a in args], cfg.row_kinds


# The host forms of the kernels' lane regions, lane loops and exchanges
# (csrc/cone_solve.cuh), for a host build of a body, and of their FMAs.
_HOST_LANES = r"""
// the kernel's lane regions and lane loops, run for lane 0, 1, ..., FS_LANES - 1
// in turn; a lane's own values, an array over the lanes (lane l's at [l])
#define FS_LANES_BEGIN for (int l = 0; l < FS_LANES; ++l) {
#define FS_LANES_END }
#define FS_EACH_BEGIN FS_LANES_BEGIN
#define FS_EACH_END FS_LANES_END
#define FS_OWN(T, x, n) T x[FS_LANES][n]
#define FS_MINE(x, i) x[l][i]
#define FS_FROM(x, i, src) x[src][i]
// the argmin over the lanes: a serial first-match scan over their partial
// minima, the least key and, among equal keys, the least index
#define FS_ARGMIN(key, k, kmin_key, kmin)                                \
  {                                                                      \
    kmin_key = key[0][0];                                                \
    kmin = k[0][0];                                                      \
    for (int l_ = 1; l_ < FS_LANES; ++l_)                                \
      if (key[l_][0] < kmin_key || (key[l_][0] == kmin_key && k[l_][0] < kmin)) { \
        kmin_key = key[l_][0];                                           \
        kmin = k[l_][0];                                                 \
      }                                                                  \
  }
static inline unsigned __float_as_uint(float x) {
  unsigned u;
  memcpy(&u, &x, sizeof u);
  return u;
}
// each FMA as the product and the sum it fuses, so that a body rounds as the
// twin does (the card's builds fuse them: their roundings differ from the
// twin's and agree with each other)
#define fmaf(a, b, c) ((a) * (b) + (c))
"""
_HOST_PRE = r"""
#include <math.h>
#include <stddef.h>
#include <string.h>
#include <vector>
#define __device__
#define __forceinline__ inline
#define __noinline__
#define __ldg(p) (*(p))
static inline float rsqrtf(float x) { return 1.0f / sqrtf(x); }
""" + _HOST_LANES
_HOST_POST = r"""
extern "C" void host_step(const float* q, const float* u, const float* tau, const float* pd,
                          const float* hts, long long hts_stride, float* qo, float* uo, int B) {
  std::vector<float> smem(FS_SMEM_WORLD);
  for (int b = 0; b < B; ++b) {
    for (float& x : smem) x = nanf("");   // a read before a write shows as NaN
    fs_body(q + (size_t)b * FS_NQ, u + (size_t)b * FS_NV, tau + (size_t)b * FS_NV,
            pd + (size_t)b * FS_NV, hts ? hts + (size_t)b * hts_stride : NULL,
            qo + (size_t)b * FS_NQ, uo + (size_t)b * FS_NV, smem.data(), 0);
  }
}
"""


def host_step(sd, tmp_path, lanes=None, opt="-O1"):
  """The generated body (`fs_body`, the kernel minus its CUDA frame) built
  as host C++ without FMA contraction (at g++'s `opt` level; each level
  rounds alike); skips without a host compiler. One thread runs each world,
  its lane regions lane after lane, at the source's FS_LANES or at `lanes`;
  the world's shared memory is a host array filled with NaN before each
  world."""
  import ctypes
  import shutil
  import subprocess

  from raisimlib_torch import _build
  from raisimlib_torch.ops import gpu_step

  cxx = shutil.which("g++")
  if cxx is None:
    pytest.skip("needs a host C++ compiler")
  src = gpu_step.kernel_source(sd)[0]
  src = src.replace("#include <cuda_runtime.h>", "").replace('#include "fused_step.cuh"', "")
  tag = "" if lanes is None else f"_l{lanes}"
  cpp, lib = tmp_path / f"fused_host{tag}.cpp", tmp_path / f"fused_host{tag}.so"
  pre = _HOST_PRE if lanes is None else f"#define FS_LANES {int(lanes)}\n" + _HOST_PRE
  cpp.write_text(pre + src + _HOST_POST)
  r = subprocess.run([cxx, opt, "-ffp-contract=off", "-w", "-shared", "-fPIC",
                      "-I", _build.CSRC, "-o", str(lib), str(cpp)],
                     capture_output=True, text=True, timeout=300)
  assert r.returncode == 0, r.stderr[:3000]
  host = ctypes.CDLL(str(lib))
  host.host_step.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong]
                             + [ctypes.c_void_p] * 2 + [ctypes.c_int])
  return host.host_step


_MF_HOST = r"""
#include <math.h>
#include <stddef.h>
#include <string.h>
#include <vector>
#define __device__
#define __host__
#define __forceinline__ inline
#define __ldg(p) (*(p))
""" + _HOST_LANES + r"""#include "mf_solve.cuh"

// the kernel's frame: blocks of wpb worlds in the layout of mf_block, one
// after another, each block's shared memory a host array filled with NaN
// before the block
extern "C" void host_mf(const float* Jr, const float* Wt, const float* vf, const float* bias,
                        const float* mu, const float* act, const int* rows, float* u,
                        float* lam, int B, int nc, int nv, int nrow, int sweeps, int n_grid) {
  const rsl::ConeConsts cc = rsl::mf_cone_consts(n_grid);
  int bytes = 0, staged = 1;
  const int wpb = rsl::mf_block(nc, nv, nrow, n_grid, &bytes, &staged);
  std::vector<float> smem((size_t)bytes / sizeof(float));
  for (int blk = 0; blk < (B + wpb - 1) / wpb; ++blk) {
    for (float& x : smem) x = nanf("");
    for (int w = 0; w < wpb; ++w) {
      if (staged)
        rsl::mf_slot<true>(Jr, Wt, vf, bias, mu, act, rows, u, lam, B, nc, nv, nrow, sweeps,
                           cc, smem.data(), blk, wpb, w, 0);
      else
        rsl::mf_slot<false>(Jr, Wt, vf, bias, mu, act, rows, u, lam, B, nc, nv, nrow, sweeps,
                            cc, smem.data(), blk, wpb, w, 0);
    }
  }
}

extern "C" int host_mf_block(int nc, int nv, int nrow, int n_grid, int* bytes, int* staged) {
  return rsl::mf_block(nc, nv, nrow, n_grid, bytes, staged);
}
"""


def host_mf(tmp_path, lanes, opt="-O1", device_rows=False):
  """K2's body (csrc/mf_solve.cuh) and its frame built as host C++ without
  FMA contraction, at FS_LANES = `lanes` (with `device_rows`, built with
  MF_DEVICE_ROWS: the device-memory layout wherever it fits); skips without
  a host compiler. Returns the library: `host_mf(Jr, Wt, vf, bias, mu, act,
  rows, u, lam, B, nc, nv, nrow, sweeps, n_grid)` on batch-first float32
  arrays (one thread runs each world, its lane regions lane after lane, in
  blocks of the kernel's worlds per block and in its layout), and
  `host_mf_block(nc, nv, nrow, n_grid, &bytes, &staged)`, the kernel's worlds
  per block, shared bytes and layout (`mf_block`)."""
  import ctypes
  import shutil
  import subprocess

  from raisimlib_torch import _build

  cxx = shutil.which("g++")
  if cxx is None:
    pytest.skip("needs a host C++ compiler")
  tag = f"l{int(lanes)}" + ("_dev" if device_rows else "")
  cpp, lib = tmp_path / f"mf_host_{tag}.cpp", tmp_path / f"mf_host_{tag}.so"
  pre = f"#define FS_LANES {int(lanes)}\n" + ("#define MF_DEVICE_ROWS\n" if device_rows else "")
  cpp.write_text(pre + _MF_HOST)
  r = subprocess.run([cxx, opt, "-ffp-contract=off", "-w", "-shared", "-fPIC",
                      "-I", _build.CSRC, "-o", str(lib), str(cpp)],
                     capture_output=True, text=True, timeout=300)
  assert r.returncode == 0, r.stderr[:3000]
  host = ctypes.CDLL(str(lib))
  host.host_mf.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
  host.host_mf_block.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
  return host


def k2_scene_runs(name, cut=None, steps=10, B=2, seed=3, down=0.7):
  """chip_smoke.py's K2 scene `name` (cut to `cut`) built by the same calls
  in both packages, float64, B seeded states (the scene's own noise; every
  free body but the constraint scene's falling at `down` m/s, so that
  contacts close within the run), stepped `steps` times by the JAX
  package's step_batch(use_kernel=False), jitted once. Returns (the JAX
  scene, the port's float64 and float32 scenes, the JAX trajectory as a
  list of (q, u) numpy pairs, steps + 1 long)."""
  import jax
  import jax.numpy as jnp
  from raisimlib_tpu.ops import pipeline as jp
  from raisimlib_tpu.ops.integrator import State as JState
  from raisimlib_tpu.world import World as JWorld
  from raisimlib_torch.world import World

  cs = load_chip_smoke()
  w, info = cs.k2_world(JWorld, name, cut, dtype=jnp.float64)
  js = w.compile(joint_limits=False)
  ts = {}
  for dtype in (torch.float64, torch.float32):
    w, _ = cs.k2_world(World, name, cut, dtype=dtype, device="cpu")
    ts[dtype] = w.compile(joint_limits=False)
  t64 = ts[torch.float64]
  q0 = cs.k2_q0(name, t64.model.q_init.numpy(), info)
  trio = name == "trio"
  s = cs.k2_states(torch, t64, q0, B, seed, dxy=0.0 if trio else 5e-3, dv=0.01 if trio else 0.0)
  u = s.u.clone()
  if not trio:
    u[:, 5::6] -= down                      # every body is a free one, 6 dofs each
  f = jax.jit(lambda q, u: jp.step_batch(js, JState(q=q, u=u, t=jnp.zeros(B)),
                                         jnp.zeros((B, js.model.nv)), use_kernel=False))
  q, u = jnp.asarray(s.q.numpy()), jnp.asarray(u.numpy())
  traj = [(np.asarray(q), np.asarray(u))]
  for _ in range(steps):
    sj = f(q, u)
    q, u = sj.q, sj.u
    traj.append((np.asarray(q), np.asarray(u)))
  return js, t64, ts[torch.float32], traj


def k2_scene_errors(t64, t32, traj, near=1e-6):
  """The port against a JAX trajectory (k2_scene_runs): (max |dq|, max |du|)
  of the float64 pure path (step_batch(use_kernel=False)) over the whole
  run; of one float32 step from each JAX state; and of one float64 step of
  the twin (the CPU side of step_batch's kernel path) from the last state
  with a world it may compare; and how many (state, world) pairs the two
  one-step comparisons took. They skip, by rule, a world with a contact
  slot within `near` of activation (|depth| < near, by the port's float64
  narrow phase at the JAX state): there a rounding puts the slot on either
  side, and the step follows (the tower's boxes start exactly touching)."""
  from raisimlib_torch.ops import collision as coll
  from raisimlib_torch.ops import dynamics, pipeline
  from raisimlib_torch.ops.integrator import State

  def state(q, u, dtype):
    return State(q=torch.tensor(q, dtype=dtype), u=torch.tensor(u, dtype=dtype),
                 t=torch.zeros(q.shape[0], dtype=dtype))

  def err(s, ref, worlds):
    return (float(np.abs(s.q.double().numpy() - ref[0])[worlds].max(initial=0.0)),
            float(np.abs(s.u.double().numpy() - ref[1])[worlds].max(initial=0.0)))

  B = traj[0][0].shape[0]
  zero = torch.zeros((B, t64.model.nv), dtype=torch.float64)
  s = state(*traj[0], torch.float64)
  for _ in traj[1:]:
    s = pipeline.step_batch(t64, s, zero, use_kernel=False)
  pure = err(s, traj[-1], np.arange(B))
  one32, compared, last = [0.0, 0.0], 0, None
  for k in range(len(traj) - 1):
    c = coll.collide(t64.geoms, t64.pairs, dynamics.fk(t64.model, torch.tensor(traj[k][0])))
    worlds = np.nonzero((c.depth.abs() >= near).all(1).numpy())[0]
    if not len(worlds):
      continue
    s = pipeline.step_batch(t32, state(*traj[k], torch.float32), zero.float(), use_kernel=False)
    one32 = [max(a, b) for a, b in zip(one32, err(s, traj[k + 1], worlds))]
    compared += len(worlds)
    last = (k, worlds)
  k, worlds = last
  twin = err(pipeline.step_batch(t64, state(*traj[k], torch.float64), zero), traj[k + 1], worlds)
  return pure, tuple(one32), twin, compared
