"""K1 at several lane counts per world (FS_LANES), on the card.

Run from the repository root on a machine with a CUDA device:

    python3 tools/lanes_sweep.py [--variants 8 32 32:1 32:16] [--batches 1 4 128 ... 16384]
                                 [--scenes flat terrain stack cylinder cone rock atlas ilqr]
                                 [--solve emitted called inlined]

For each scene, flat ANYmal (K1a, chip_smoke.py's phase 11), ANYmal on the
64 fractal terrains with the trot scene's gains (K1c, the trot MPPI's
kernel), the sphere-box stack (K1b, phase 21) and the debris scenes
(cylinder, cone, rock: K1c, phase 26), Atlas (K1a at nv = 29, 32 slots,
phase 31) and the iLQR scene (ANYmal at dt = 0.01 s, phases 35-37; by
default the first three), it builds the generated
source once per variant "G" or "G:M" (FS_LANES = G lanes per world, and
__launch_bounds__' minimum of M blocks per SM, which caps the registers;
without M, gpu_step.min_blocks' choice at G; one nvcc each, all in
parallel), and once per `--solve` kind: "emitted" (the default), the
source as the emitter writes it at G (the LANES source for another G);
"called", that source with the line that takes the cone solve out of line
(each contact slot of a sweep calls its one copy); "inlined", the same
without it, so that every slot inlines its own copy (cone_solve.cuh's
default). The sweep prints which of the two the emitter writes
(`gpu_step.solve_called`). At each batch of `--batches` it launches
every build on the same states: first chip_smoke.py's start states, where
each build is held to the twin `_fused_plain` at chip_smoke.py's K1 tiers,
then those states 20 steps on (200 for the debris, which land in 90-150;
contacts active), where each build is timed
alone (CUDA events, 20 launches after a warm-up). Prints one line per
(scene, variant, solve, B) and ptxas's figures per build, and with --json
PATH writes the rows there. With "called" and "inlined" it prints, at each
(scene, variant, B), the called build's time over the inlined one's and
whether the two gave the same bits from the start states. After each scene
it prints, at each batch, the width the kernel's rule takes
(`FusedKernel.lanes`) beside the fastest of the LANES and WIDE builds that
the rule would build (the variants without M, the first solve kind). Exits
non-zero if a build disagrees with the twin (for Atlas: more than
chip_smoke.py's ATLAS_BRANCH_SHARE of the worlds past the ceiling) or with
the other solve kind.

With --clocks it also builds each scene's source at LANES and at WIDE lanes
with clock64() reads at the phase boundaries, launches each once at each
batch from the 20-step states, and prints, for the first world of the first
block, the cycles of phases A-E, F-G (the triangular solves and the hoisted
blocks), H (the sweeps) and I (integration and stores), and phase H per
cone solve (H over the sweeps times the contact slots; the limit rows'
share included).
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# the line of the generated head that takes the cone solve out of line
SOLVE_CALL = "#define RSL_CONE_SOLVE_ATTR __noinline__\n"
INCLUDE = '#include "cone_solve.cuh"'


def with_clocks(src, cones):
  """The generated source with clock64() reads at the phase boundaries and a
  printf of their differences from lane 0 of the first world, and of phase
  H's over `cones`."""
  lines = src.splitlines()
  at = lambda key: next(i for i, ln in enumerate(lines) if key in ln)   # noqa: E731
  sweep = at("for (int sweep")
  depth, end = 0, None
  for i in range(sweep, len(lines)):
    depth += lines[i].count("{") - lines[i].count("}")
    if depth == 0:
      end = i
      break
  marks = {at("const rsl::ConeConsts cc"): "c0", at("float* const jt = fs_smem"): "c1",
           at("float* const z = fs_smem"): "c2"}
  out = ["#include <cstdio>"]
  for i, ln in enumerate(lines):
    if i in marks:
      out.append(f"  const long long {marks[i]} = clock64();")
    out.append(ln)
    if i == end:
      out.append("  const long long c3 = clock64();")
  text = "\n".join(out)
  stamp = ('  if (blockIdx.x == 0 && threadIdx.x == 0) printf("    %lld %lld %lld %lld; %lld\\n", '
           f"c1 - c0, c2 - c1, c3 - c2, clock64() - c3, (c3 - c2) / {max(cones, 1)});\n")
  tail = text.rindex("}\n\n}  // namespace")
  return text[:tail] + stamp + text[tail:]


def main():
  import torch

  import chip_smoke as cs
  from raisimlib_torch import _build
  from raisimlib_torch.ops import gpu_step as gs

  ap = argparse.ArgumentParser()
  ap.add_argument("--variants", nargs="+", default=["8", "32", "32:1", "32:16"])
  ap.add_argument("--batches", type=int, nargs="+",
                  default=[1, 4, 128, 384, 768, 1024, 2048, 4096, 16384])
  ap.add_argument("--scenes", nargs="+", default=["flat", "terrain", "stack"],
                  choices=["flat", "terrain", "stack", "cylinder", "cone", "rock", "atlas",
                           "ilqr"])
  ap.add_argument("--solve", nargs="+", default=["emitted"],
                  choices=["emitted", "called", "inlined"])
  ap.add_argument("--clocks", action="store_true")
  ap.add_argument("--json", help="write the rows to this file")
  args = ap.parse_args()
  if not torch.cuda.is_available():
    sys.exit("lanes_sweep.py needs a CUDA device")
  smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
  print(f"card: {smi.stdout.strip()}", flush=True)
  variants = [tuple(int(x) for x in (v + ":0").split(":")[:2]) for v in args.variants]

  from raisimlib_torch.examples import atlas_batch as ex_atlas
  from raisimlib_torch.mpc import balance_ilqr

  hts64 = cs.make_terrains(torch, 64)
  atlas_q0 = {}

  def atlas_scene():
    scene, atlas_q0["q0"], _ = ex_atlas.build_scene()
    return scene

  make = {"flat": lambda: cs.anymal_scene(torch),
          "terrain": lambda: cs.anymal_scene(torch, kp=120.0, kd=3.0, terrain=True),
          "stack": lambda: cs.stack_scene(torch),
          "cylinder": lambda: cs.debris_scene(torch, "cylinder"),
          "cone": lambda: cs.debris_scene(torch, "cone"),
          "rock": lambda: cs.debris_scene(torch, "mesh"),
          "atlas": atlas_scene,
          "ilqr": balance_ilqr.balance_scene}
  scenes = {k: make[k]() for k in args.scenes}
  steps = {k: gs.make_step_batch_fused(sc, use_pd=k in ("flat", "terrain", "atlas", "ilqr"))
           for k, sc in scenes.items()}

  def start_states(label, B):
    """(state, tau, pd or None, heights or None) of chip_smoke.py's phases."""
    seed = 40 + B % 97
    hts = hts64.repeat((B + 63) // 64, 1, 1)[:B].contiguous()
    if label == "stack":
      s = cs.loose_states(torch, scenes[label], B, seed=seed, kick=(3, cs.STACK["kick_m_s"]))
      return s, torch.zeros_like(s.u), None, None
    if label in ("flat", "ilqr"):
      s, pd, _ = cs.standing_states(torch, scenes[label], B, seed=seed)
      return s, torch.zeros_like(pd), pd, None
    if label == "atlas":
      s, tau, pd = cs.atlas_states(torch, scenes[label], atlas_q0["q0"], B, seed=seed)
      return s, tau, pd, None
    if label == "terrain":
      s, pd, _ = cs.terrain_states(torch, scenes[label], hts, seed=seed)
      return s, torch.zeros_like(pd), pd, hts
    s = cs.debris_states(torch, scenes[label], hts, seed=seed)
    return s, torch.zeros_like(s.u), None, hts

  builds, kept = {}, {}
  for label, step in steps.items():
    print(f"{label}: {len(step.sd.slots)} contact slots, nv = {step.sd.nv}; the emitter calls "
          f"the cone solve at " + ", ".join(f"{G} lanes: {step.kernel.called[G]}"
                                            for G in (gs.LANES, gs.WIDE)), flush=True)
    for G, M in variants:
      if not M and G in (gs.LANES, gs.WIDE):
        kept[label, G] = M or gs.min_blocks(step.sd, G)
      try:
        smem = gs.smem_bytes(step.sd, G)
      except gs.FusedStepUnsupported as e:
        print(f"{label}, G={G}: {e}", flush=True)
        continue
      M = M or gs.min_blocks(step.sd, G)
      head = f"#define FS_LANES {G}\n#define FS_MIN_BLOCKS {M}\n"
      emitted = step.kernel.sources.get(G, step.kernel.source)
      inlined = emitted.replace(SOLVE_CALL, "")
      text = {"emitted": emitted, "called": inlined.replace(INCLUDE, SOLVE_CALL + INCLUDE),
              "inlined": inlined}
      for kind in args.solve:
        builds[label, G, M, kind] = (_build.add_generated(f"fused_step_l{G}_m{M}_{kind}",
                                                          head + text[kind], gs._SYMBOLS,
                                                          gs._FLAGS), smem)
  clocked = {(label, G): _build.add_generated(
      "fused_step_clocks", f"#define FS_LANES {G}\n#define FS_MIN_BLOCKS {gs.min_blocks(step.sd, G)}\n"
      + with_clocks(step.kernel.sources[G], step.sd.sweeps * len(step.sd.slots)), gs._SYMBOLS,
      gs._FLAGS)
      for label, step in steps.items() for G in (gs.LANES, gs.WIDE)} if args.clocks else {}
  built = _build.build([n for n, _ in builds.values()] + list(clocked.values())
                       + [n for st in steps.values() for n in st.kernel.names.values()])
  rows, bad = [], []
  stream = torch.cuda.current_stream().cuda_stream
  for label, step in steps.items():
    for (lb, G, M, kind), (name, smem) in builds.items():
      if lb == label:
        print(f"{label}, G={G}, min blocks {M}, {kind}: nvcc {built.get(name, 0.0):.1f} s, {smem} "
              f"bytes of shared memory per block; ptxas {_build.ptxas_figures(name)}", flush=True)
    with torch.inference_mode():
      for B in args.batches:
        s, tau, pd, hts = start_states(label, B)
        hp, stride = (None, 0) if hts is None else (hts.data_ptr(), hts.stride(0))
        qp, up = gs._fused_plain(step.sd, s.q, s.u, tau, pd, step.heights(s.q, hts))
        s20 = s
        for _ in range(20 if label in ("flat", "terrain", "stack", "atlas", "ilqr") else 200):
          s20 = step(s20, tau, pd, field_heights=hts)
        for G in (gs.LANES, gs.WIDE) if clocked else ():
          print(f"  {label}, B={B}, G={G}: cycles of A-E, F-G, H, I; then H per cone solve "
                f"(H / {step.sd.sweeps * len(step.sd.slots)}):", flush=True)
          qo, uo = torch.empty_like(s.q), torch.empty_like(s.u)
          _build.load(clocked[label, G]).fused_step_launch(
              s20.q.data_ptr(), s20.u.data_ptr(), tau.data_ptr(),
              None if pd is None else pd.data_ptr(), hp, stride, qo.data_ptr(), uo.data_ptr(), B,
              stream)
          torch.cuda.synchronize()
          ctypes.CDLL(None).fflush(None)              # the device's printf, before ours
        outs = {}
        for (lb, G, M, kind), (name, smem) in builds.items():
          if lb != label:
            continue
          lib = _build.load(name)
          qo, uo = torch.empty_like(s.q), torch.empty_like(s.u)

          def launch(x):
            return lib.fused_step_launch(x.q.data_ptr(), x.u.data_ptr(), tau.data_ptr(),
                                         None if pd is None else pd.data_ptr(), hp, stride,
                                         qo.data_ptr(), uo.data_ptr(), B, stream)

          rc = launch(s)
          torch.cuda.synchronize()
          if rc != 0:
            sys.exit(f"{label}, G={G}, B={B}: launch failed, cudaError {rc}")
          dq = (qo - qp).abs().amax(1)
          du = (uo - up).abs().amax(1)
          frac = float(((dq <= cs.K1_TIGHT[0]) & (du <= cs.K1_TIGHT[1])).float().mean())
          over = float(((dq > cs.K1_CEILING[0]) | (du > cs.K1_CEILING[1])).float().mean())
          ok = frac >= 0.99 and over <= (cs.ATLAS_BRANCH_SHARE if label == "atlas" else 0.0)
          outs[G, M, kind] = (qo.clone(), uo.clone())
          ms = cs.time_cuda(torch, lambda: launch(s20), 20)
          rows.append({"scene": label, "lanes": G, "min_blocks": M, "solve": kind, "B": B,
                       "kernel_ms": ms, "smem_block_bytes": smem, "within_tight": frac,
                       "max_dq": float(dq.max()), "max_du": float(du.max()),
                       "ptxas": _build.ptxas_figures(name)})
          print(f"  {label}, G={G}, min blocks {M}, {kind}, B={B}: {ms:.4f} ms; vs twin: {frac:.4f} "
                f"within the tight tier, max |dq| {float(dq.max()):.2e}, max |du| "
                f"{float(du.max()):.2e}{'' if ok else '  DISAGREES'}", flush=True)
          if not ok:
            bad.append(f"{label} G={G} M={M} {kind} B={B}")
        for G, M in sorted({(G, M) for G, M, _ in outs}):
          if not {"called", "inlined"} <= set(args.solve):
            break
          (qc, uc), (qi, ui) = outs[G, M, "called"], outs[G, M, "inlined"]
          same = torch.equal(qc, qi) and torch.equal(uc, ui)
          ms = {r["solve"]: r["kernel_ms"] for r in rows if r["scene"] == label and r["B"] == B
                and r["lanes"] == G and r["min_blocks"] == M}
          print(f"  {label}, G={G}, min blocks {M}, B={B}: called / inlined "
                f"{ms['called']:.4f} / {ms['inlined']:.4f} ms = {ms['called'] / ms['inlined']:.3f}; "
                f"{'the same bits' if same else 'BITS DIFFER'}", flush=True)
          if not same:
            bad.append(f"{label} G={G} M={M} B={B}: called and inlined differ")
        times = {r["lanes"]: r["kernel_ms"] for r in rows if r["scene"] == label
                 and r["B"] == B and kept.get((label, r["lanes"])) == r["min_blocks"]
                 and r["solve"] == args.solve[0]}
        if len(times) == 2:
          rule = step.kernel.lanes(B, s.q.device)
          best = min(times, key=times.get)
          print(f"  {label}, B={B}: the rule takes G={rule}, the faster is G={best} "
                f"({times[gs.LANES]:.4f} against {times[gs.WIDE]:.4f} ms)"
                f"{'' if rule == best else '  RULE MISSES'}", flush=True)
  if args.json:
    with open(args.json, "w") as f:
      json.dump({"card": smi.stdout.strip(), "rows": rows}, f, indent=1)
  if bad:
    sys.exit("disagrees: " + ", ".join(bad))


if __name__ == "__main__":
  main()
