"""The harness: every cell resolves to its files by name, names and units
keep to their characters, a new configuration, cell and per-layer metric
come in as new files alone, nothing imports JAX (or the JAX package, or
the system from the reference), and a run with no card gives no result."""

import ast
import hashlib
import math
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from portbench.run import FORBIDDEN, PKG, ROOT, cell_files, cell_metrics, execute, load_json, \
    module

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench(root=ROOT):
  return load_json(os.path.join(root, "BENCHMARK.json"))


def test_every_cell_resolves():
  bench = _bench()
  assert bench["paths"] == ["portbench"]
  for w in bench["workloads"]:
    _, wl, cfg = cell_files(bench, w["name"])
    assert wl["config"] == w["config"] == cfg["name"]
    assert hasattr(module("drivers", wl["driver"]), "Cell")
    assert set(wl["limits"]) and all(v > 0 for v in wl["limits"].values())
    e2e = cell_metrics(bench, w["name"], "end_to_end")
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    layer = cell_metrics(bench, w["name"], "per_layer")
    assert layer and all(callable(module("layer_metrics", m["name"]).read) for m in layer)
  for c in bench["configs"]:
    assert os.path.exists(os.path.join(ROOT, c["file"]))
    assert load_json(os.path.join(ROOT, c["file"]))["reduced"] == c["reduced"]


def test_names_and_units_keep_to_their_characters():
  bench = _bench()
  names = ([m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
           + [w["name"] for w in bench["workloads"]] + [c["name"] for c in bench["configs"]]
           + [w[k] for w in bench["workloads"] for k in ("config", "traffic")]
           + [k for c in bench["configs"] for k in c["reduced"]])
  assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
  assert len(set(m["name"] for m in bench["end_to_end"] + bench["per_layer"])) == len(
      bench["end_to_end"] + bench["per_layer"])
  units = [m["unit"] for m in bench["end_to_end"] + bench["per_layer"]]
  assert all(UNIT.match(u) for u in units), units
  for text in ([w["why"] for w in bench["workloads"]] + [c["source"] for c in bench["configs"]]
               + [m["layer"] for m in bench["per_layer"]] + bench["command"]):
    assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
  for root, _, files in os.walk(PKG):
    for f in files:
      rel = os.path.relpath(os.path.join(root, f), ROOT)
      assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def _digest(path):
  out = {}
  for root, dirs, files in os.walk(path):
    dirs[:] = [d for d in dirs if d not in ("__pycache__", "out")]
    for f in files:
      with open(os.path.join(root, f), "rb") as fh:
        out[os.path.relpath(os.path.join(root, f), path)] = hashlib.sha256(fh.read()).hexdigest()
  return out


def test_a_new_cell_config_and_metric_come_as_new_files(tmp_path):
  """In a copy of the benchmark: a configuration, a cell and a per-layer
  metric added as files (and their BENCHMARK.json entries) are found and
  run, and no file that was there changes."""
  root = str(tmp_path)
  shutil.copytree(PKG, os.path.join(root, "portbench"),
                  ignore=shutil.ignore_patterns("__pycache__", "out"))
  before = _digest(os.path.join(root, "portbench"))
  bench = _bench()
  cfg = load_json(os.path.join(PKG, "configs", "anymal_flat.json"))
  cfg["name"] = "anymal_flat_soft"
  cfg["world"]["pd_gains"] = {"kp": 80.0, "kd": 2.0}
  with open(os.path.join(root, "portbench", "configs", "anymal_flat_soft.json"), "w") as f:
    json.dump(cfg, f)
  wl = cell_files(bench, "anymal_flat-rollouts")[1]
  wl["config"] = "anymal_flat_soft"
  with open(os.path.join(root, "portbench", "workloads", "anymal_flat_soft-rollouts.json"),
            "w") as f:
    json.dump(wl, f)
  with open(os.path.join(root, "portbench", "layer_metrics", "batches.rollouts.py"), "w") as f:
    f.write("def read(trace):\n  return float(len(trace.spans.named('step')))\n")
  bench["configs"].append({"name": "anymal_flat_soft", "source": "a softer gain set",
                           "file": "portbench/configs/anymal_flat_soft.json", "reduced": [],
                           "why": "a test"})
  bench["workloads"].append({"name": "anymal_flat_soft-rollouts", "config": "anymal_flat_soft",
                             "traffic": "rollouts", "chips": 1, "why": "a test"})
  next(m for m in bench["end_to_end"] if m["name"] == "world_steps_per_s")["workloads"].append(
      "anymal_flat_soft-rollouts")
  bench["per_layer"].append({"name": "batches.rollouts", "unit": "1", "better": "higher",
                             "source": "program_span", "layer": "step",
                             "moves": "world_steps_per_s",
                             "workloads": ["anymal_flat_soft-rollouts"]})
  with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
    json.dump(bench, f)
  after = _digest(os.path.join(root, "portbench"))
  assert all(after[k] == v for k, v in before.items())
  assert set(after) - set(before) == {"configs/anymal_flat_soft.json",
                                      "workloads/anymal_flat_soft-rollouts.json",
                                      "layer_metrics/batches.rollouts.py"}
  assert [m["name"] for m in cell_metrics(bench, "anymal_flat_soft-rollouts", "per_layer")] \
      == ["batches.rollouts"]
  assert module("layer_metrics", "batches.rollouts", root).read
  out = execute(bench, "anymal_flat_soft-rollouts", 5, 0.1, trace=False, device="cpu",
                overrides=wl["rehearsal"], root=root)
  assert out["correct"] and out["metrics"]["world_steps_per_s"]["value"] > 0


def _imports(path):
  with open(path) as f:
    tree = ast.parse(f.read())
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      yield from (a.name for a in node.names)
    elif isinstance(node, ast.ImportFrom) and node.level == 0:
      yield node.module


def test_nothing_imports_jax_and_the_reference_nothing_of_the_system():
  banned = set(FORBIDDEN) | {"bench", "chip_smoke", "tools"}
  for root, _, files in os.walk(PKG):
    for f in files:
      if not f.endswith(".py"):
        continue
      path = os.path.join(root, f)
      tops = {m.split(".")[0] for m in _imports(path)}
      assert not tops & banned, (path, tops & banned)
      if os.sep + "reference" + os.sep in path:
        assert "raisimlib_torch" not in tops, path


def _run(cwd, env=None):
  return subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                         "anymal_flat-rollouts", "--seed", "2147483999", "--seconds", "1",
                         "--trace", "0"], cwd=cwd, capture_output=True, text=True, timeout=300,
                        env=dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env or {})))


def test_no_card_no_result():
  """Without a CUDA device the command fails and prints nothing."""
  r = _run(ROOT)
  assert r.returncode != 0 and r.stdout == ""
  assert "no result" in r.stderr


def test_no_system_no_result(tmp_path):
  """In a directory that holds only BENCHMARK.json and portbench/, the
  command fails and prints nothing."""
  shutil.copytree(PKG, os.path.join(tmp_path, "portbench"),
                  ignore=shutil.ignore_patterns("__pycache__", "out"))
  shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
  r = _run(str(tmp_path), env={"PYTHONPATH": ""})
  assert r.returncode != 0 and r.stdout == ""


@pytest.mark.parametrize("name", ["anymal_flat-rollouts"])
def test_command_is_the_module(name):
  bench = _bench()
  assert bench["command"] == ["python3", "-m", "portbench.run"]
  assert name in {w["name"] for w in bench["workloads"]}


def test_largest_gap_sets_aside_only_rows_at_their_activation():
  """`*_gap_max` passes over at most `set_aside` rows, and only rows whose
  activation margin lies under `margin`; any other row counts."""
  import torch

  from portbench.compare import gaps

  lim = {"q_gap_p99": 1.0, "q_gap_max": 1.0, "u_gap_p99": 1.0, "u_gap_max": 0.5,
         "margin": 1e-6, "set_aside": 2}
  du = torch.full((400, 3), 1e-5, dtype=torch.float64)
  margin = torch.full((400,), 1e-3, dtype=torch.float64)
  du[:2, 0], margin[:2] = 4.0, 1e-8                   # two flips at the margin: set aside
  got = {n: v for n, v, _ in gaps(torch.zeros_like(du), du, margin, lim)}
  assert got["u_gap_max"] == pytest.approx(1e-5)
  du[2, 0], margin[2] = 4.0, 1e-8                     # a third: beyond set_aside
  assert {n: v for n, v, _ in gaps(du * 0, du, margin, lim)}["u_gap_max"] == 4.0
  du[2, 0], margin[2] = 0.0, 1e-3
  du[7, 0] = 0.7                                      # one row away from any activation
  got = {n: v for n, v, _ in gaps(du * 0, du, margin, lim)}
  assert got["u_gap_max"] == pytest.approx(0.7) and got["u_gap_p99"] < 1e-4
  du[9, 1] = float("nan")
  assert math.isnan({n: v for n, v, _ in gaps(du * 0, du, margin, lim)}["u_gap_max"])
