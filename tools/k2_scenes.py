"""chip_smoke.py's phases 38-41 alone: the scenes outside K1's class (the box
tower, the box pile, the mixed drop, the constraints) on the K2 path, with
their gates, K2 against its twin and K2's times.

Run from the repository root on a machine with a CUDA device:

    python3 tools/k2_scenes.py [--scenes tower pile mixed trio] [--json PATH]

Prints what chip_smoke.py prints for these phases (about 3 minutes for all
four on an H100), then one JSON line of the kernels line's K2 entries and
the scenes' records; exits non-zero if a gate or a check fails.
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
  ap.add_argument("--scenes", nargs="+", default=["tower", "pile", "mixed", "trio"])
  ap.add_argument("--json", help="write the entries and records to this file")
  args = ap.parse_args()
  sys.path.insert(0, ROOT)
  import torch

  import chip_smoke as cs
  from raisimlib_torch import _build
  from raisimlib_torch.ops import gpu_contact as gc
  from raisimlib_torch.ops import gpu_step as gs

  if not torch.cuda.is_available():
    sys.exit("k2_scenes.py needs a CUDA device")
  smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
  card = smi.stdout.strip()
  print(f"card: {card}", flush=True)
  t0 = time.perf_counter()
  cs.register_device_build(_build)
  _build.build(["mf_solve", cs.MF_DEVICE_BUILD])
  print(f"K2 build {time.perf_counter() - t0:.1f} s", flush=True)
  cs.K2_PHASES = tuple(p for p in cs.K2_PHASES if p[2] in args.scenes)
  entries, recs = cs.run_k2_scenes(torch, gs, gc, card)
  out = {"card": card, "kernels": entries, "scenes": recs}
  if args.json:
    with open(args.json, "w") as f:
      json.dump(out, f, indent=1)
  print(json.dumps(out), flush=True)


if __name__ == "__main__":
  main()
