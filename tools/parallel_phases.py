"""chip_smoke.py's phases 42-48 alone: the parallel layer at world size 1
(one NCCL rank in this process), the checkpoint of a card State and the
profiling helpers; with phase 8's K1 rollouts first, the unsharded figure
that phase 42's sharded one stands beside.

Run from the repository root on a machine with a CUDA device:

    python3 tools/parallel_phases.py [--json PATH]

Builds the kernels these phases launch (K2, the flat ANYmal's K1, the
iLQR scene's K1 and Atlas's K1; one nvcc each, in parallel), prints what
chip_smoke.py prints for the phases (about 2 minutes on an H100), then one
JSON line of their record; exits non-zero if a check fails.
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
  ap = argparse.ArgumentParser()
  ap.add_argument("--json", help="write the record to this file")
  args = ap.parse_args()
  sys.path.insert(0, ROOT)
  import torch

  import chip_smoke as cs
  from raisimlib_torch import _build
  from raisimlib_torch.examples import atlas_batch as ex_atlas
  from raisimlib_torch.mpc import balance_ilqr
  from raisimlib_torch.ops import gpu_contact as gc
  from raisimlib_torch.ops import gpu_step as gs

  if not torch.cuda.is_available():
    sys.exit("parallel_phases.py needs a CUDA device")
  smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
  card = smi.stdout.strip()
  print(f"card: {card}", flush=True)
  t0 = time.perf_counter()
  scene = cs.anymal_scene(torch)
  fused = gs.make_step_batch_fused(scene)
  fused.kernel
  il_step = gs.make_step_batch_fused(balance_ilqr.balance_scene())
  il_step.kernel
  gs.make_step_batch_fused(ex_atlas.build_scene()[0]).kernel
  built = _build.build()
  print(f"build {time.perf_counter() - t0:.1f} s: {built}", flush=True)
  B, H = 16384, 50
  print(f"phase 8: make_step_batch_fused (K1) rollouts, B={B}, H={H}", flush=True)
  with torch.inference_mode():
    s0, pd, _ = cs.standing_states(torch, scene, B, seed=2)
    zero = torch.zeros_like(pd)
    _, t_roll1, _ = cs.rollouts(torch, lambda st, p: fused(st, zero, p), s0, pd, H, gc, gs,
                                "K1")
  rec = cs.run_parallel(torch, gs, gc, scene, s0, pd, H, t_roll1, il_step, card)
  out = {"card": card, "parallel": rec}
  if args.json:
    with open(args.json, "w") as f:
      json.dump(out, f, indent=1, default=str)
  print(json.dumps(out, default=str), flush=True)


if __name__ == "__main__":
  main()
