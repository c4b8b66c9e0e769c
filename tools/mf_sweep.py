"""K2 (the matrix-free solve, csrc/mf_solve.cu) at several lane counts, on
the card; and the K2 path's rollouts and MPPI alone, for A/B runs.

Run from the repository root on a machine with a CUDA device:

    python3 tools/mf_sweep.py [--variants 4 8 16 8:device] [--batches 384 2048 16384]
    python3 tools/mf_sweep.py --root DIR [--batches ...]
    python3 tools/mf_sweep.py --path [--root DIR]

Each variant "G" is a build of csrc/mf_solve.cu with MF_LANES = G lanes per
world; "G:device" is the same with the J rows left in device memory (read
with __ldg) and only the W rows staged in shared memory, a source this tool
makes from mf_solve.cuh for the comparison (`j_in_device_memory`); one nvcc
each, all in parallel. At each batch the inputs are the main path's: the
ANYmal solver inputs (12 cone + 12 lin rows, nv = 18) of chip_smoke.py's
perturbed standing states. Each build is held to the twin `_mf_plain` at
chip_smoke.py's tiers (check_kernel's lam tiers and its u bound) and timed
alone (CUDA events, 20 launches after a warm-up); the kept build is also
timed through its wrapper, `solve_dynamics_batch`. Prints one line per
(variant, B), with the bound of `mf_solve_cost` at that B, and ptxas's
figures per build; with --json PATH it writes the rows there. Exits non-zero
if a build disagrees with the twin.

With --clocks it also builds the kept variant with clock64() reads in the
world's body, launches it once at each batch, and prints, for the first
world of the first block, the cycles of the staging, the hoisted dots, the
sweeps (and within them the cone solves and the lin rows) and the stores.

With --root DIR it imports raisimlib_torch and chip_smoke.py from the
checkout DIR instead (for example a `git archive` of an earlier commit) and
times only that checkout's K2, alone (`launch_kernel` on `kernel_inputs`)
and through its wrapper, with no variants: the way to hold two commits'
kernels side by side in one chip call.

With --path it runs only chip_smoke.py's phases 3 and 4 (the K2 path's
50-step rollouts at B = 16384 and its balance MPPI, with their launch-count
checks) from the checkout (or DIR) and prints rollouts/s and MPPI solves/s:
run it in turns from two checkouts (parent, change, change, parent, ...) to
compare the two end to end.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def with_clocks(body):
  """mf_solve.cuh's text with clock64() reads at the phase boundaries, around
  each cone solve and each lin row, and a printf of the cycles from the
  first lane of the first world of the first block."""
  marks = [
      ("  // ---- the world's rows into shared memory", "  const long long ck0 = clock64();\n"),
      ("  // ---- hoisted per-row invariants", "  const long long ck1 = clock64();\n"),
      ("  // ---- Gauss-Seidel sweeps",
       "  const long long ck2 = clock64();\n  long long t_cone = 0, t_lin = 0;\n"),
      ("      if (kind == kMfLin) {\n", None),
      ("        continue;\n", "        t_lin += clock64() - tl;\n"),
      ("        rsl::cone_solve_lanes(", "        const long long tc = clock64();\n"),
      ("  // ---- stores", "  const long long ck3 = clock64();\n"),
  ]
  for key, text in marks:
    if key not in body:
      raise SystemExit(f"mf_sweep --clocks: marker {key!r} not in mf_solve.cuh")
    if text is None:
      body = body.replace(key, key + "        const long long tl = clock64();\n", 1)
    else:
      body = body.replace(key, text + key, 1)
  call = body.index("rsl::cone_solve_lanes(")
  end = body.index(";", call) + 1
  body = body[:end] + "\n        t_cone += clock64() - tc;" + body[end:]
  tail = body.index("  FS_LANES_END\n}\n\n// World slot")
  stamp = ('  if (blockIdx.x == 0 && threadIdx.x == 0) printf("    staging %lld, hoisted dots %lld, '
           'sweeps %lld (cone solves %lld, lin rows %lld), stores %lld\\n", ck1 - ck0, ck2 - ck1, '
           'ck3 - ck2, t_cone, t_lin, clock64() - ck3);\n')
  end = tail + len("  FS_LANES_END\n")
  return "#include <cstdio>\n" + body[:end] + stamp + body[end:]


def j_in_device_memory(body):
  """mf_solve.cuh's text with the J rows read from device memory: no J rows
  in the world's shared arrays, none staged, and MF_J pointing into Jr."""
  subs = [
      ("  o.js = off;\n  off += nrow * nv;\n", "  o.js = off;\n"),
      ("        js[t] = jv[b];\n", ""),
      ("#define MF_J(i) (js + (size_t)__ldg(slot + (i)) * nv)",
       "#define MF_J(i) (Jr + ((size_t)3 * (i) + (__ldg(kinds + (i)) == kMfLin ? 2 : 0)) * nv)"),
  ]
  for key, text in subs:
    if body.count(key) != 1:
      raise SystemExit(f"mf_sweep: {key!r} not once in mf_solve.cuh")
    body = body.replace(key, text)
  return body


def launch(torch, gc, lib, ins, rows, cfg):
  """One launch of the build `lib` on kernel_inputs' tensors: (u, lam)."""
  B, nc, _, nv = ins[0].shape
  u = torch.empty((B, nv), dtype=torch.float32, device="cuda")
  lam = torch.empty((B, nc, 3), dtype=torch.float32, device="cuda")
  rc = lib.mf_solve_launch(*(x.data_ptr() for x in ins), rows.data_ptr(), u.data_ptr(),
                           lam.data_ptr(), B, nc, nv, gc._used_rows(cfg.row_kinds), cfg.sweeps,
                           cfg.n_grid, torch.cuda.current_stream().cuda_stream)
  if rc != 0:
    raise RuntimeError(f"mf_solve launch failed: cudaError {rc}")
  return u, lam


def block(gc, lib, nc, nv, cfg):
  """(worlds per block, shared bytes per block) of the build `lib`."""
  nbytes = ctypes.c_int(0)
  wpb = lib.mf_solve_block(nc, nv, gc._used_rows(cfg.row_kinds), cfg.n_grid,
                           ctypes.byref(nbytes))
  return wpb, nbytes.value


def run_path(torch, cs, scene, gc, gs):
  """chip_smoke.py's phases 3 and 4: (rollouts/s, MPPI solves/s)."""
  B, H = 16384, 50
  with torch.inference_mode():
    s0, pd, q0 = cs.standing_states(torch, scene, B, seed=2)
    _, t, counts = cs.rollouts(torch, lambda st, p: scene.step_batch(st, pd_target=p),
                               s0, pd, H, gc, gs, "K2")
  if counts != (H, 0):
    sys.exit(f"K2 rollouts launched (K2, K1) {counts} times for {H} steps")
  t_mppi, counts, steps = cs.run_mppi(torch, scene, q0, "never", gc, gs)
  if counts != (steps, 0):
    sys.exit(f"K2 MPPI launched (K2, K1) {counts} times for {steps} steps")
  return B / t, 16 * 2 / t_mppi                     # run_mppi: 16 envs, 2 updates


def main():
  ap = argparse.ArgumentParser()
  ap.add_argument("--variants", nargs="+", default=["4", "8", "16", "8:device", "16:device"])
  ap.add_argument("--batches", type=int, nargs="+", default=[384, 2048, 16384])
  ap.add_argument("--root", help="time the K2 of the checkout in this directory instead")
  ap.add_argument("--clocks", action="store_true")
  ap.add_argument("--path", action="store_true",
                  help="run only the K2 path's rollouts and MPPI (chip_smoke.py phases 3-4)")
  ap.add_argument("--json", help="write the rows to this file")
  args = ap.parse_args()
  root = os.path.abspath(args.root) if args.root else ROOT
  sys.path.insert(0, root)
  import torch

  import chip_smoke as cs
  from raisimlib_torch import _build
  from raisimlib_torch.ops import gpu_contact as gc
  from raisimlib_torch.ops import gpu_step as gs
  from raisimlib_torch.ops import pipeline

  if not torch.cuda.is_available():
    sys.exit("mf_sweep.py needs a CUDA device")
  smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
  card = smi.stdout.strip()
  print(f"card: {card}; raisimlib_torch from {root}", flush=True)

  if args.path:
    _build.build(["mf_solve"])
    roll, mppi = run_path(torch, cs, cs.anymal_scene(torch), gc, gs)
    print(f"K2 path: rollouts/s {roll:.1f}, MPPI solves/s {mppi:.3f}", flush=True)
    if args.json:
      with open(args.json, "w") as f:
        json.dump({"card": card, "tree": root, "rollouts_per_s": roll, "mppi_solves_per_s": mppi},
                  f, indent=1)
    return

  variants = {}
  if not args.root:
    with open(os.path.join(_build.CSRC, "mf_solve.cuh")) as f:
      body = f.read()
    with open(_build.KERNELS["mf_solve"]["source"]) as f:
      frame = f.read()
    symbols = _build.KERNELS["mf_solve"]["symbols"]
    for v in args.variants:
      G, _, where = v.partition(":")
      G = int(G)
      if where == "device":
        text = frame.replace('#include "mf_solve.cuh"', j_in_device_memory(body))
        name = _build.add_generated(f"mf_solve_l{G}_jdev", f"#define MF_LANES {G}\n" + text,
                                    symbols)
      else:
        name = f"mf_solve_l{G}"
        _build.KERNELS[name] = dict(source=_build.KERNELS["mf_solve"]["source"],
                                    defines=(f"-DMF_LANES={G}",), symbols=symbols)
      variants[name] = (G, where or "shared")
  clocked = None
  if args.clocks and not args.root:
    text = frame.replace('#include "mf_solve.cuh"', with_clocks(body))
    clocked = _build.add_generated("mf_solve_clocks", f"#define MF_LANES {_build.MF_LANES}\n"
                                   + text, _build.KERNELS["mf_solve"]["symbols"])
  built = _build.build(list(variants) + ["mf_solve"] + ([clocked] if clocked else []))
  for name in ["mf_solve"] + list(variants):
    print(f"{name}: nvcc {built.get(name, 0.0):.1f} s; ptxas {_build.ptxas_figures(name)}",
          flush=True)

  scene = cs.anymal_scene(torch)
  rows, bad = [], []
  with torch.inference_mode():
    for B in args.batches:
      s, pd, _ = cs.standing_states(torch, scene, B, seed=30 + B % 97)
      xs, cfg = pipeline.solver_inputs(scene, s, torch.zeros_like(pd), pd)
      nc, nv = xs[0].shape[1], xs[0].shape[3]
      nbytes, nops = gc.mf_solve_cost(B, nc, nv, cfg.row_kinds, cfg.sweeps, cfg.n_grid)
      bound = max(nbytes / cs.H100_BYTES_PER_S, nops / cs.H100_F32_OPS_PER_S) * 1e3
      up, lp = gc._mf_plain(*xs, cfg)
      scale = float(lp.abs().max()) + 1.0
      ins, table = gc.kernel_inputs(*xs, cfg)
      wrapper_ms = cs.time_cuda(torch, lambda: gc.solve_dynamics_batch(*xs, cfg), 20)
      kernel_ms = cs.time_cuda(torch, lambda: gc.launch_kernel(ins, table, cfg), 20)
      row = {"tree": root, "variant": "kept", "B": B, "kernel_ms": kernel_ms,
             "wrapper_ms": wrapper_ms, "bound_ms": bound, "ptxas": _build.ptxas_figures("mf_solve")}
      rows.append(row)
      print(f"  kept build, B={B}: kernel alone {kernel_ms:.4f} ms, through the wrapper "
            f"{wrapper_ms:.4f} ms; bound {bound:.4f} ms", flush=True)
      if clocked:
        print(f"  B={B}, cycles of world 0:", flush=True)
        launch(torch, gc, _build.load(clocked), ins, table, cfg)
        torch.cuda.synchronize()
        ctypes.CDLL(None).fflush(None)              # the device's printf, before ours
      for name, (G, where) in variants.items():
        lib = _build.load(name)
        wpb, smem = block(gc, lib, nc, nv, cfg)
        u, lam = launch(torch, gc, lib, ins, table, cfg)
        torch.cuda.synchronize()
        rel = (lam - lp).abs() / scale
        frac, relmax = float((rel < 1e-4).float().mean()), float(rel.max())
        u_rel = float((u - up).abs().max()) / (float(up.abs().max()) + 1.0)
        ok = frac >= 0.99 and relmax < 3e-2 and u_rel < 3e-2
        ms = cs.time_cuda(torch, lambda: launch(torch, gc, lib, ins, table, cfg), 20)
        rows.append({"tree": root, "variant": f"{G}:{where}", "lanes": G, "j_rows": where,
                     "B": B, "kernel_ms": ms, "bound_ms": bound, "worlds_per_block": wpb,
                     "smem_block_bytes": smem, "within_1e-4": frac, "max_rel": relmax,
                     "u_max_rel": u_rel, "ptxas": _build.ptxas_figures(name)})
        print(f"  G={G}, J in {where} memory, B={B}: {ms:.4f} ms ({wpb} worlds, {smem} B of "
              f"shared memory a block); vs twin: {frac:.4f} within 1e-4, max rel {relmax:.2e}, "
              f"u max rel {u_rel:.2e}{'' if ok else '  DISAGREES'}", flush=True)
        if not ok:
          bad.append(f"G={G} J in {where} B={B}")
  if args.json:
    with open(args.json, "w") as f:
      json.dump({"card": card, "rows": rows}, f, indent=1)
  if bad:
    sys.exit("disagrees with the twin: " + ", ".join(bad))


if __name__ == "__main__":
  main()
