"""The control of the `atlas_rollouts` driver's comparison, and its faults:
`portbench.control` for the humanoid's reference.

    python3 -m portbench.control_atlas --workload atlas-rollouts --seeds 1 2 ... \
        --control-seeds 101 102 103 [--faults unchanged altered rare] [--seconds S] [--out FILE]

The control is the humanoid's reference (`reference.atlas.Scene`) in the
system's place, computed one precision below the configuration's float32:
with TF32 matrix products (`control.TF32Products`), captured as a CUDA
graph. The faults are `control.faults`' rollout faults (a step that returns
its state unchanged, the first joint velocity moved by 0.1 in every world or
by 3 in one world of 64). The runs and what they print are
`portbench.control`'s: each run's compared numbers, the readings the limits
of portbench/workloads/atlas-rollouts.json are set from.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from types import SimpleNamespace

import torch

from portbench import control as base
from portbench.reference import atlas
from portbench.run import ROOT, cell_files, execute, load_json


def control(cfg: dict, p: dict, driver: str):
  """The substitute of the cell's system: the humanoid's reference in
  float32 + TF32."""
  def rollout(scene):
    ref_step = base._tf32_step(atlas.Scene(cfg["world"], torch.float32, scene.device))

    def step(state, tau, pd, field_heights=None):
      q, u = ref_step(state.q, state.u, pd)
      return SimpleNamespace(q=q, u=u, t=state.t)

    return step

  return rollout


def faults(p: dict, driver: str, kind: str):
  """`control.faults`' rollout fault `kind` for the cell's system."""
  return base.faults(p, "rollouts", kind)


def main(argv=None) -> int:
  ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  ap.add_argument("--workload", required=True)
  ap.add_argument("--seeds", type=int, nargs="*", default=[])
  ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
  ap.add_argument("--faults", nargs="*", default=[], choices=("unchanged", "altered", "rare"))
  ap.add_argument("--seconds", type=float, default=2.0)
  ap.add_argument("--out", default=None)
  args = ap.parse_args(argv)
  bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
  _, wl, cfg = cell_files(bench, args.workload)
  runs = ([("system", s, None) for s in args.seeds]
          + [("control", s, control(cfg, wl["params"], wl["driver"]))
             for s in args.control_seeds]
          + [(f"fault_{k}", s, faults(wl["params"], wl["driver"], k))
             for k in args.faults for s in args.control_seeds[:1] or [1]])
  with open(args.out, "a") if args.out else open(os.devnull, "w") as f:
    for what, seed, sub in runs:
      t0 = time.perf_counter()
      out = execute(bench, args.workload, seed, args.seconds, trace=False, substitute=sub)
      rec = {"workload": args.workload, "run": what, "seed": seed, "correct": out["correct"],
             "checks": {n: c["value"] for n, c in out["checks"].items()},
             "metrics": {n: m["value"] for n, m in out["metrics"].items()},
             "seconds": time.perf_counter() - t0}
      print(json.dumps(rec), flush=True)
      f.write(json.dumps(rec) + "\n")
      f.flush()
  return 0


if __name__ == "__main__":
  sys.exit(main())
