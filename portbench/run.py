"""Run one benchmark cell of the PyTorch + CUDA port on the card.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's name is looked up in BENCHMARK.json; its workload file
(portbench/workloads/<cell>.json) names the configuration and the driver
(portbench/drivers/<driver>.py) and holds the traffic's parameters and the
limits of its comparison with the plain reference. The run builds the
configuration's scene, makes every input from the seed, warms up the cell's
shapes (set-up), measures for `--seconds`, compares what the timed path
produced with the reference (portbench/reference/), and prints one JSON
line last. With `--trace 1` the window runs under torch.profiler and the
line holds the per-layer metrics (portbench/layer_metrics/<metric>.py)
instead of the end-to-end ones.

It refuses to run without a CUDA device, and fails if JAX or the JAX
package has been imported by the time the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import platform  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "portbench")
FORBIDDEN = ("jax", "jaxlib", "flax", "raisimlib_tpu")


def load_json(path: str):
  with open(path) as f:
    return json.load(f)


def cell_files(bench: dict, name: str, root: str = ROOT):
  """(BENCHMARK.json's entry of the cell, its workload file, its
  configuration file), each as loaded, from the checkout at `root`."""
  cells = {w["name"]: w for w in bench["workloads"]}
  if name not in cells:
    raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
  cell = cells[name]
  wl = load_json(os.path.join(root, "portbench", "workloads", f"{name}.json"))
  conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
  return cell, wl, load_json(os.path.join(root, conf["file"]))


def cell_metrics(bench: dict, name: str, key: str):
  """The metrics of `key` ("end_to_end" or "per_layer") that the cell
  reports: those that list it, or list no cells and move a metric it
  reports."""
  e2e = [m["name"] for m in bench["end_to_end"]
         if name in m.get("workloads", [name])]
  return [m for m in bench[key] if name in m.get("workloads", [name])
          and (key == "end_to_end" or "workloads" in m or m["moves"] in e2e)]


def module(kind: str, name: str, root: str = ROOT):
  """portbench/<kind>/<name>.py of the checkout at `root`, loaded by path
  (a metric's name holds dots)."""
  path = os.path.join(root, "portbench", kind, f"{name}.py")
  spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name}", path)
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod


def forbidden_modules():
  return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def card_state() -> str:
  """nvidia-smi's name, clocks, power draw and limit, temperature."""
  try:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,clocks.sm,clocks.mem,power.draw,power.limit,"
         "temperature.gpu", "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30)
    return out.stdout.strip() or out.stderr.strip()
  except (OSError, subprocess.TimeoutExpired) as e:
    return f"nvidia-smi: {e}"


def log(*a):
  print(*a, file=sys.stderr, flush=True)


class Trace:
  """What a per-layer reader reads: the profiler's summary, the host spans
  and the configuration's frozen yardstick."""

  def __init__(self, summary, spans, cfg):
    self.summary, self.spans, self.yardstick = summary, spans, cfg["yardstick"]


def execute(bench, name, seed, seconds, trace, device="cuda", t_start=None,
            overrides=None, substitute=None, root=ROOT):
  """Run one cell; returns the result dict (the last line's keys, and
  "checks"). `overrides` replace traffic parameters and `substitute`
  stands in for parts of the system (the CPU rehearsal, the control and
  the fault tests use them; the command passes neither)."""
  import torch

  from portbench import trace as tr

  t_start = time.perf_counter() if t_start is None else t_start
  spans = tr.Spans()
  spans.mark("imports")
  _, wl, cfg = cell_files(bench, name, root)
  params = dict(wl["params"], **(overrides or {}))
  torch.set_num_threads(1)
  on_card = device != "cpu"
  if on_card:
    torch.zeros(1, device=device)
    spans.mark("context")
  driver = module("drivers", wl["driver"], root)
  run = driver.Cell(cfg, params, seed, torch.device(device), spans, substitute)
  if on_card:
    torch.cuda.synchronize()
  # what set-up made lives on: a full collection inside the window would
  # scan it all (tens of ms in a tick), so it moves to the permanent generation
  gc.collect()
  gc.freeze()
  spans.mark("gc")
  setup_s = time.perf_counter() - t_start
  steps, t = [], t_start
  for step, at in spans.marks:
    steps.append(f"{step} {at - t:.3f}")
    t = at
  log(f"setup_s {setup_s!r} ({', '.join(steps)} s); card before the window: "
      f"{card_state() if on_card else 'cpu'}")

  summary = None
  if trace:
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    spans.on = True
    with profile(activities=acts) as prof:
      with spans("window"):
        e2e = run.window(seconds)
    spans.on = False
    t0 = time.perf_counter()
    summary = tr.Summary(prof, {r[0] for r in spans.records})
    log(f"trace: {summary.n_device_ops} device operations, {summary.n_linked} linked to "
        f"their launch, reduced in {time.perf_counter() - t0:.1f} s; events "
        f"{dict(summary.kinds)}")
    del prof
  else:
    e2e = run.window(seconds)
  gc.unfreeze()
  log(f"card after the window: {card_state() if on_card else 'cpu'}")
  peak = torch.cuda.max_memory_allocated() if on_card else 0
  for line in run.notes():
    log(line)

  run.release()
  checks = run.compare(wl["limits"])
  correct = all(v <= lim for _, v, lim in checks)   # a NaN fails
  metrics = {}
  if not trace:
    for m in cell_metrics(bench, name, "end_to_end"):
      v = setup_s if m["name"] == "setup_s" else e2e[m["name"]]
      metrics[m["name"]] = {"value": v, "unit": m["unit"]}
  else:
    data = Trace(summary, spans, cfg)
    for m in cell_metrics(bench, name, "per_layer"):
      v = module("layer_metrics", m["name"], root).read(data)
      if v is not None:
        metrics[m["name"]] = {"value": v, "unit": m["unit"]}
  kind = torch.cuda.get_device_name(0) if on_card else platform.processor() or "cpu"
  device_rec = {"platform": "gpu" if on_card else "cpu", "kind": kind, "count": 1,
                "memory_peak_bytes": peak}
  out = {"correct": correct, "attempted": run.attempted, "failed": run.failed,
         "metrics": metrics, "device": device_rec}
  if trace:
    device_rec["busy_s"] = summary.busy_s
    device_rec["window_s"] = summary.window_s
    out["breakdown"] = {"device_ops": [list(x) for x in summary.device_ops],
                        "idle_gaps": [list(x) for x in summary.idle_gaps]}
  out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
  return out


def main(argv=None) -> int:
  ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  ap.add_argument("--workload", required=True)
  ap.add_argument("--seed", type=int, required=True)
  ap.add_argument("--seconds", type=float, required=True)
  ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
  args = ap.parse_args(argv)
  bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
  cell = cell_files(bench, args.workload)[0]

  import torch

  if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
    log(f"no result: the cell needs {cell['chips']} CUDA device(s), "
        f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    return 2
  log(f"host: {platform.node()} {platform.processor() or platform.machine()}, "
      f"{os.cpu_count()} cpus; torch {torch.__version__} cuda {torch.version.cuda}")
  out = execute(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                t_start=T_START)
  bad = forbidden_modules()
  if bad:
    log(f"no result: the process imported {bad}")
    return 3
  for n, c in out["checks"].items():
    log(f"check {n} {c['value']!r} limit {c['limit']!r}")
  print(json.dumps(out), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
