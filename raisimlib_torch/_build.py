"""Build and load the hand-written CUDA kernels of `csrc/`.

Each kernel source compiles with `nvcc` for `sm_90a` into a shared library
with a plain C entry point, loaded with ctypes (no PyTorch headers, so a build
takes seconds). Libraries go to `_build/` beside this file, named by a hash of
the sources and flags, and are built at first use. `build()` starts one `nvcc`
per missing library, all at once, and waits for them together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

# per-thread capacity of the matrix-free solve (local arrays in mf_solve.cu);
# the wrapper raises above these
MF_MAX_NC = 48
MF_MAX_NV = 64

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNELS = {
    "mf_solve": dict(
        source="mf_solve.cu",
        defines=(f"-DMF_MAX_NC={MF_MAX_NC}", f"-DMF_MAX_NV={MF_MAX_NV}"),
        symbols={"mf_solve_launch": [_P] * 9 + [_I] * 5 + [_P]},
    ),
}
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_loaded: dict = {}
# what ptxas said about each kernel (registers, spills), kept for the record
build_logs: dict = {}


def _nvcc() -> str:
  path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
  if not os.path.exists(path):
    raise RuntimeError("nvcc not found: the CUDA kernels of raisimlib_torch "
                       "build on a machine with the CUDA toolkit")
  return path


def _lib_path(name: str) -> str:
  spec = KERNELS[name]
  h = hashlib.sha256()
  for fn in sorted(os.listdir(CSRC)):
    if fn.endswith((".cu", ".cuh")):
      with open(os.path.join(CSRC, fn), "rb") as f:
        h.update(fn.encode() + f.read())
  h.update(" ".join(FLAGS + spec["defines"]).encode())
  return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build(names=None) -> dict:
  """Compile the named kernels (default: all) that are not built yet, one
  nvcc process each, in parallel. Returns {name: seconds} for those built."""
  names = list(KERNELS) if names is None else list(names)
  todo = [n for n in names if not os.path.exists(_lib_path(n))]
  if not todo:
    return {}
  os.makedirs(BUILD_DIR, exist_ok=True)
  nvcc = _nvcc()
  procs = {}
  t0 = time.perf_counter()
  for n in todo:
    out = _lib_path(n)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc, *FLAGS, *KERNELS[n]["defines"], "-o", tmp,
           os.path.join(CSRC, KERNELS[n]["source"])]
    procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True), tmp, out)
  times, failed = {}, []
  for n, (p, tmp, out) in procs.items():
    log, _ = p.communicate()
    build_logs[n] = log
    if p.returncode != 0:
      failed.append(f"{n}:\n{log}")
      continue
    os.replace(tmp, out)
    times[n] = time.perf_counter() - t0
  if failed:
    raise RuntimeError("nvcc failed for " + "\n".join(failed))
  return times


def load(name: str) -> ctypes.CDLL:
  """The kernel's library, built at first use, with argtypes set."""
  lib = _loaded.get(name)
  if lib is None:
    build([name])
    lib = ctypes.CDLL(_lib_path(name))
    for sym, argtypes in KERNELS[name]["symbols"].items():
      fn = getattr(lib, sym)
      fn.argtypes = argtypes
      fn.restype = ctypes.c_int
    _loaded[name] = lib
  return lib
