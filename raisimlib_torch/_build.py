"""Build and load the hand-written CUDA kernels of `csrc/`.

Each kernel source compiles with `nvcc` for `sm_90a` into a shared library
with a plain C entry point, loaded with ctypes (no PyTorch headers, so a build
takes seconds). Libraries go to `_build/` beside this file, named by a hash of
the sources and flags, and are built at first use. `build()` starts one `nvcc`
per missing library, all at once, and waits for them together.

Two kinds of source: the fixed ones of `csrc/` (`KERNELS`), and sources
generated per scene (the fused step, ops/gpu_step.py), which
`add_generated` writes into `_build/` under a name that hashes the generated
text, the headers of `csrc/` and the flags.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

# the matrix-free solve's build: MF_LANES lanes of a warp per world
MF_LANES = 16

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNELS = {
    "mf_solve": dict(
        source=os.path.join(CSRC, "mf_solve.cu"),
        defines=(f"-DMF_LANES={MF_LANES}",),
        symbols={"mf_solve_launch": [_P] * 9 + [_I] * 6 + [_P],
                 "mf_solve_block": [_I] * 4 + [_P, _P]},
    ),
}
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_loaded: dict = {}
# what nvcc and ptxas said about each kernel built here, kept for the record
# (`ptxas_figures` reads registers, stack, spills and shared memory from it)
build_logs: dict = {}
_PTXAS = {"registers": r"Used (\d+) registers", "stack_bytes": r"(\d+) bytes stack frame",
          "spill_stores": r"(\d+) bytes spill stores", "spill_loads": r"(\d+) bytes spill loads",
          "smem_bytes": r"(\d+) bytes smem"}


def ptxas_figures(name: str) -> dict:
  """ptxas's figures for the kernel `name`, from its -v output: registers per
  thread, stack frame, spill stores and loads, and static shared memory per
  block (bytes; dynamic shared memory is set at launch and not counted). The
  largest over the file's kernels; 0 where ptxas names none, and None for
  each when this process did not build the library (it was on disk)."""
  log = build_logs.get(name)
  return {k: None if log is None else max((int(x) for x in re.findall(pat, log)), default=0)
          for k, pat in _PTXAS.items()}


def _nvcc() -> str:
  path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
  if not os.path.exists(path):
    raise RuntimeError("nvcc not found: the CUDA kernels of raisimlib_torch "
                       "build on a machine with the CUDA toolkit")
  return path


def _digest(extra: bytes, defines) -> str:
  """Hash of every source in csrc/, `extra`, the flags and the defines."""
  h = hashlib.sha256()
  for fn in sorted(os.listdir(CSRC)):
    if fn.endswith((".cu", ".cuh")):
      with open(os.path.join(CSRC, fn), "rb") as f:
        h.update(fn.encode() + f.read())
  h.update(extra)
  h.update(" ".join(FLAGS + tuple(defines)).encode())
  return h.hexdigest()[:16]


def _lib_path(name: str) -> str:
  spec = KERNELS[name]
  if spec.get("generated"):
    return os.path.join(BUILD_DIR, f"{name}.so")
  return os.path.join(BUILD_DIR, f"{name}-{_digest(b'', spec['defines'])}.so")


def add_generated(stem: str, text: str, symbols: dict, flags=(), lazy: bool = False) -> str:
  """Register a generated kernel source (compiled against csrc/'s headers,
  with nvcc's `flags` after FLAGS) and return its name, `stem`-<hash>. The
  source is written into `_build/`; nothing is compiled until `build` or
  `load`, and a `lazy` one only by `load` or by name."""
  name = f"{stem}-{_digest(text.encode(), flags)}"
  if name not in KERNELS:
    os.makedirs(BUILD_DIR, exist_ok=True)
    path = os.path.join(BUILD_DIR, f"{name}.cu")
    if not os.path.exists(path):
      tmp = f"{path}.{os.getpid()}.tmp"
      with open(tmp, "w") as f:
        f.write(text)
      os.replace(tmp, path)
    KERNELS[name] = dict(source=path, defines=tuple(flags), symbols=symbols, generated=True,
                         lazy=lazy)
  return name


def build(names=None) -> dict:
  """Compile the named kernels (default: all registered but the lazy ones)
  that are not built yet, one nvcc process each, in parallel. Returns
  {name: seconds} for those built."""
  names = [n for n in KERNELS if not KERNELS[n].get("lazy")] if names is None else list(names)
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
    cmd = [nvcc, *FLAGS, *KERNELS[n]["defines"], "-I", CSRC, "-o", tmp,
           KERNELS[n]["source"]]
    procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True), tmp, out)
  times, failed = {}, []
  for n, (p, tmp, out) in procs.items():
    log, _ = p.communicate()
    build_logs[n] = log
    if p.returncode != 0:
      failed.append(f"{n}:\n{log[:4000]}")
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
