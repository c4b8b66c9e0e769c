"""K1 at several lane counts per world (FS_LANES), on the card.

Run from the repository root on a machine with a CUDA device:

    python3 tools/lanes_sweep.py [--variants 4 8 16 8:12] [--batches 384 1024 2048 16384]
                                 [--scenes flat terrain stack cylinder cone rock]

For each scene, flat ANYmal (K1a, chip_smoke.py's phase 11), ANYmal on the
64 fractal terrains with the trot scene's gains (K1c, the trot MPPI's
kernel), the sphere-box stack (K1b, phase 21) and the debris scenes
(cylinder, cone, rock: K1c, phase 26; by default the first three), it
builds the generated
source once per variant "G" or "G:M" (FS_LANES = G lanes per world, and
__launch_bounds__' minimum of M blocks per SM, which caps the registers;
without M, gpu_step.min_blocks' choice at G; one nvcc each, all in
parallel). At each batch of `--batches` it launches
every build on the same states: first chip_smoke.py's start states, where
each build is held to the twin `_fused_plain` at chip_smoke.py's K1 tiers,
then those states 20 steps on (200 for the debris, which land in 90-150;
contacts active), where each build is timed
alone (CUDA events, 20 launches after a warm-up). Prints one line per
(scene, variant, B) and ptxas's figures per build, and with --json PATH
writes the rows there. Exits non-zero if a build disagrees with the twin.

With --clocks it also builds each scene's kept source with clock64() reads
at the phase boundaries, launches it once at each batch from the 20-step
states, and prints, for the first world of the first block, the cycles of
phases A-E, F-G (the triangular solves and the hoisted blocks), H (the
sweeps) and I (integration and stores).
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def with_clocks(src):
  """The generated source with clock64() reads at the phase boundaries and a
  printf of their differences from lane 0 of the first world."""
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
  stamp = ('  if (blockIdx.x == 0 && threadIdx.x == 0) printf("    %lld %lld %lld %lld\\n", '
           "c1 - c0, c2 - c1, c3 - c2, clock64() - c3);\n")
  tail = text.rindex("}\n\n}  // namespace")
  return text[:tail] + stamp + text[tail:]


def main():
  import torch

  import chip_smoke as cs
  from raisimlib_torch import _build
  from raisimlib_torch.ops import gpu_step as gs

  ap = argparse.ArgumentParser()
  ap.add_argument("--variants", nargs="+", default=["4", "8", "16"])
  ap.add_argument("--batches", type=int, nargs="+", default=[384, 1024, 2048, 16384])
  ap.add_argument("--scenes", nargs="+", default=["flat", "terrain", "stack"],
                  choices=["flat", "terrain", "stack", "cylinder", "cone", "rock"])
  ap.add_argument("--clocks", action="store_true")
  ap.add_argument("--json", help="write the rows to this file")
  args = ap.parse_args()
  if not torch.cuda.is_available():
    sys.exit("lanes_sweep.py needs a CUDA device")
  smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
  print(f"card: {smi.stdout.strip()}", flush=True)
  variants = [tuple(int(x) for x in (v + ":0").split(":")[:2]) for v in args.variants]

  hts64 = cs.make_terrains(torch, 64)
  make = {"flat": lambda: cs.anymal_scene(torch),
          "terrain": lambda: cs.anymal_scene(torch, kp=120.0, kd=3.0, terrain=True),
          "stack": lambda: cs.stack_scene(torch),
          "cylinder": lambda: cs.debris_scene(torch, "cylinder"),
          "cone": lambda: cs.debris_scene(torch, "cone"),
          "rock": lambda: cs.debris_scene(torch, "mesh")}
  scenes = {k: make[k]() for k in args.scenes}
  steps = {k: gs.make_step_batch_fused(sc, use_pd=k in ("flat", "terrain"))
           for k, sc in scenes.items()}

  def start_states(label, B):
    """(state, tau, pd or None, heights or None) of chip_smoke.py's phases."""
    seed = 40 + B % 97
    hts = hts64.repeat((B + 63) // 64, 1, 1)[:B].contiguous()
    if label == "stack":
      s = cs.loose_states(torch, scenes[label], B, seed=seed, kick=(3, cs.STACK["kick_m_s"]))
      return s, torch.zeros_like(s.u), None, None
    if label == "flat":
      s, pd, _ = cs.standing_states(torch, scenes[label], B, seed=seed)
      return s, torch.zeros_like(pd), pd, None
    if label == "terrain":
      s, pd, _ = cs.terrain_states(torch, scenes[label], hts, seed=seed)
      return s, torch.zeros_like(pd), pd, hts
    s = cs.debris_states(torch, scenes[label], hts, seed=seed)
    return s, torch.zeros_like(s.u), None, hts

  builds = {}
  for label, step in steps.items():
    for G, M in variants:
      try:
        smem = gs.smem_bytes(step.sd, G)
      except gs.FusedStepUnsupported as e:
        print(f"{label}, G={G}: {e}", flush=True)
        continue
      M = M or gs.min_blocks(step.sd, G)
      head = f"#define FS_LANES {G}\n#define FS_MIN_BLOCKS {M}\n"
      builds[label, G, M] = (_build.add_generated(f"fused_step_l{G}_m{M}",
                                                  head + step.kernel.source, gs._SYMBOLS), smem)
  clocked = {label: _build.add_generated("fused_step_clocks", with_clocks(step.kernel.source),
                                         gs._SYMBOLS)
             for label, step in steps.items()} if args.clocks else {}
  built = _build.build([n for n, _ in builds.values()] + [st.kernel.name for st in steps.values()]
                       + list(clocked.values()))
  rows, bad = [], []
  stream = torch.cuda.current_stream().cuda_stream
  for label, step in steps.items():
    for (lb, G, M), (name, smem) in builds.items():
      if lb == label:
        print(f"{label}, G={G}, min blocks {M}: nvcc {built.get(name, 0.0):.1f} s, {smem} bytes of "
              f"shared memory per block; ptxas {_build.ptxas_figures(name)}", flush=True)
    with torch.inference_mode():
      for B in args.batches:
        s, tau, pd, hts = start_states(label, B)
        hp, stride = (None, 0) if hts is None else (hts.data_ptr(), hts.stride(0))
        qp, up = gs._fused_plain(step.sd, s.q, s.u, tau, pd, step.heights(s.q, hts))
        s20 = s
        for _ in range(20 if label in ("flat", "terrain", "stack") else 200):
          s20 = step(s20, tau, pd, field_heights=hts)
        if label in clocked:
          print(f"  {label}, B={B}, G={gs.LANES}: cycles of A-E, F-G, H, I:", flush=True)
          qo, uo = torch.empty_like(s.q), torch.empty_like(s.u)
          _build.load(clocked[label]).fused_step_launch(
              s20.q.data_ptr(), s20.u.data_ptr(), tau.data_ptr(),
              None if pd is None else pd.data_ptr(), hp, stride, qo.data_ptr(), uo.data_ptr(), B,
              stream)
          torch.cuda.synchronize()
          ctypes.CDLL(None).fflush(None)              # the device's printf, before ours
        for (lb, G, M), (name, smem) in builds.items():
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
          ok = (frac >= 0.99 and float(dq.max()) <= cs.K1_CEILING[0]
                and float(du.max()) <= cs.K1_CEILING[1])
          ms = cs.time_cuda(torch, lambda: launch(s20), 20)
          rows.append({"scene": label, "lanes": G, "min_blocks": M, "B": B, "kernel_ms": ms,
                       "smem_block_bytes": smem, "within_tight": frac, "max_dq": float(dq.max()),
                       "max_du": float(du.max()), "ptxas": _build.ptxas_figures(name)})
          print(f"  {label}, G={G}, min blocks {M}, B={B}: {ms:.4f} ms; vs twin: {frac:.4f} "
                f"within the tight tier, max |dq| {float(dq.max()):.2e}, max |du| "
                f"{float(du.max()):.2e}{'' if ok else '  DISAGREES'}", flush=True)
          if not ok:
            bad.append(f"{label} G={G} M={M} B={B}")
  if args.json:
    with open(args.json, "w") as f:
      json.dump({"card": smi.stdout.strip(), "rows": rows}, f, indent=1)
  if bad:
    sys.exit("disagrees with the twin: " + ", ".join(bad))


if __name__ == "__main__":
  main()
