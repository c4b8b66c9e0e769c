"""Rehearse a cell end to end on the CPU at a tiny size, with the kernels'
plain twins standing in for them; never a measurement.

    python3 -m portbench.rehearse --workload <cell> [--seed N] [--seconds S]

The workload file's `rehearsal` parameters replace its traffic's sizes.
The run takes the same path as `portbench.run` (set-up, window, the
comparison with the reference) and writes its result to
portbench/out/<cell>.json; its times are of the CPU and mean nothing for
the card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from portbench.run import PKG, ROOT, cell_files, execute, forbidden_modules, load_json


def rehearse(name: str, seed: int = 1, seconds: float = 0.5, substitute=None) -> dict:
  bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
  _, wl, _ = cell_files(bench, name)
  return execute(bench, name, seed, seconds, trace=False, device="cpu",
                 overrides=wl["rehearsal"], substitute=substitute)


def main(argv=None) -> int:
  ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  ap.add_argument("--workload", required=True)
  ap.add_argument("--seed", type=int, default=1)
  ap.add_argument("--seconds", type=float, default=0.5)
  args = ap.parse_args(argv)
  out = rehearse(args.workload, args.seed, args.seconds)
  out["imported"] = forbidden_modules()
  os.makedirs(os.path.join(PKG, "out"), exist_ok=True)
  with open(os.path.join(PKG, "out", f"{args.workload}.json"), "w") as f:
    json.dump(out, f, indent=1)
  print(json.dumps(out))
  return 0 if out["correct"] and not out["imported"] else 1


if __name__ == "__main__":
  sys.exit(main())
