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
                materials=np.asarray(scene.materials),
                gravity=np.asarray(scene.gravity),
                kp=np.asarray(scene.kp), kd=np.asarray(scene.kd))
  static = dict(name=m.name, parent=m.parent, joint_types=m.joint_types,
                q_adr=m.q_adr, v_adr=m.v_adr, nq=m.nq, nv=m.nv,
                body_names=m.body_names, gtype=g.gtype, geom_body=g.body,
                geom_material=g.material, pairs=scene.pairs,
                constraints=tuple(scene.constraints), dt=scene.dt,
                objects=scene.objects)
  if getattr(scene, "field", None) is not None:
    arrays.update(field_heights=np.asarray(scene.field.heights),
                  field_center=np.asarray(scene.field.center))
    static.update(field_size=(scene.field.size_x, scene.field.size_y))
  return arrays, static


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


_HOST_PRE = r"""
#include <math.h>
#include <stddef.h>
#define __device__
#define __forceinline__ inline
#define __ldg(p) (*(p))
static inline float rsqrtf(float x) { return 1.0f / sqrtf(x); }
"""
_HOST_POST = r"""
extern "C" void host_step(const float* q, const float* u, const float* tau, const float* pd,
                          const float* hts, long long hts_stride, float* qo, float* uo, int B) {
  for (int b = 0; b < B; ++b)
    fs_body(q + (size_t)b * FS_NQ, u + (size_t)b * FS_NV, tau + (size_t)b * FS_NV,
            pd + (size_t)b * FS_NV, hts ? hts + (size_t)b * hts_stride : NULL,
            qo + (size_t)b * FS_NQ, uo + (size_t)b * FS_NV);
}
"""


def host_step(sd, tmp_path):
  """The generated body (`fs_body`, the kernel minus its CUDA frame) built
  as host C++ without FMA contraction; skips without a host compiler."""
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
  cpp, lib = tmp_path / "fused_host.cpp", tmp_path / "fused_host.so"
  cpp.write_text(_HOST_PRE + src + _HOST_POST)
  r = subprocess.run([cxx, "-O1", "-ffp-contract=off", "-w", "-shared", "-fPIC",
                      "-I", _build.CSRC, "-o", str(lib), str(cpp)],
                     capture_output=True, text=True, timeout=300)
  assert r.returncode == 0, r.stderr[:3000]
  host = ctypes.CDLL(str(lib))
  host.host_step.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong]
                             + [ctypes.c_void_p] * 2 + [ctypes.c_int])
  return host.host_step
