"""The control of the comparison: the reference put in the system's place,
computed one precision below the configuration's float32 (TF32 off), i.e.
with TF32 matrix products. A sound comparison has to call it not correct.

    python3 -m portbench.control --workload <cell> --seeds 1 2 ... \
        --control-seeds 101 102 103 [--seconds S] [--out FILE]

runs the system on each of `--seeds` and the control on each of
`--control-seeds`, all in one process on the card, and prints (and writes
to FILE as JSON lines) each run's compared numbers: the readings the
limits in portbench/workloads/<cell>.json are set from. The faults that
the comparison must catch (a step that returns its state unchanged, an
answer altered where it is produced, in every world or in one world of 64)
are in `faults`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from types import SimpleNamespace

import torch
from torch.overrides import TorchFunctionMode

from portbench.reference import mpc as rmpc
from portbench.reference.collide import Field
from portbench.reference.step import Scene as RefScene
from portbench.run import ROOT, cell_files, execute, load_json


_PRODUCTS = {torch.matmul, torch.Tensor.__matmul__, torch.Tensor.__rmatmul__,
             torch.Tensor.matmul, torch.bmm, torch.mm, torch.einsum}


def to_tf32(x):
  """float32 rounded to nearest on TF32's 10-bit mantissa."""
  return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


class TF32Products(TorchFunctionMode):
  """Every matrix product of float32 operands computed as TF32 tensor cores
  do: the operands rounded to TF32, the sums in float32. torch's own TF32
  switch does not serve: cuBLAS keeps the reference's small batched
  products off the tensor cores, and the reference under it reads within a
  factor of 1.5 of float32."""

  def __torch_function__(self, func, types, args=(), kwargs=None):
    if func in _PRODUCTS:
      args = tuple(to_tf32(a) if isinstance(a, torch.Tensor) and a.dtype == torch.float32
                   else a for a in args)
    return func(*args, **(kwargs or {}))


class Graphed:
  """`fn(*tensors) -> tuple of tensors`, captured as a CUDA graph once per
  set of input shapes and replayed (the reference's step issues some 25,000
  small kernels, which eager launches make slow); eager on the CPU."""

  def __init__(self, fn):
    self.fn, self.graphs = fn, {}

  def __call__(self, *args):
    if not args[0].is_cuda:
      return self.fn(*args)
    key = tuple(None if a is None else (tuple(a.shape), a.dtype) for a in args)
    if key not in self.graphs:
      static = [None if a is None else a.clone() for a in args]
      side = torch.cuda.Stream()
      side.wait_stream(torch.cuda.current_stream())
      with torch.cuda.stream(side):
        self.fn(*static)
      torch.cuda.current_stream().wait_stream(side)
      graph = torch.cuda.CUDAGraph()
      with torch.cuda.graph(graph):
        out = self.fn(*static)
      self.graphs[key] = (graph, static, out)
    graph, static, out = self.graphs[key]
    for dst, a in zip(static, args):
      if a is not None:
        dst.copy_(a)
    graph.replay()
    return tuple(o.clone() for o in out)


def _tf32_step(ref: RefScene):
  def step(q, u, pd, heights=None):
    with TF32Products():
      return ref.step(q, u, pd, heights)

  return Graphed(step)


def _tf32_dyn(ref: RefScene, substeps: int):
  nq = ref.model.nq

  def dyn(X, A, ctx=None):
    with TF32Products():
      q, u = X[:, :nq], X[:, nq:]
      pd = torch.zeros_like(u)
      pd[:, 6:] = A
      for _ in range(substeps):
        q, u = ref.step(q, u, pd, ctx)
      return (torch.cat([q, u], 1),)

  return Graphed(dyn)


def control(cfg: dict, p: dict, driver: str):
  """The substitute of a cell's system: the reference in float32 + TF32."""
  def rollout(scene):
    ref_step = _tf32_step(RefScene(cfg["world"], torch.float32, scene.device))

    def step(state, tau, pd, field_heights=None):
      q, u = ref_step(state.q, state.u, pd, field_heights)
      return SimpleNamespace(q=q, u=u, t=state.t)

    return step

  def mpc(scene, cell):
    dyn = _tf32_dyn(RefScene(cfg["world"], torch.float32, scene.device), int(p["substeps"]))
    if p["task"] == "trot":
      def field_of(h):
        return Field(h, torch.zeros(2, dtype=h.dtype, device=h.device), cell.size)

      rc, fc = rmpc.trot_costs(float(p["v_target"]), float(p["control_dt"]), field_of)
    else:
      rc, fc = rmpc.balance_costs(p["cost"], float(p["control_dt"]))

    def mppi(dyn_b, _rc, _fc, x0s, Us, config, eps_white, env_ctx=None):
      with TF32Products():
        E, H, nu = Us.shape
        K = eps_white.shape[1]
        Us_k = rmpc.samples(Us, eps_white, config.smooth).reshape(E * K, H, nu)
        X = x0s[:, None].expand(E, K, x0s.shape[1]).reshape(E * K, -1)
        ctx = () if env_ctx is None else (env_ctx.repeat_interleave(K, 0),)
        cost = torch.zeros(E * K, dtype=X.dtype, device=X.device)
        for t in range(H):
          cost = cost + rc(X, Us_k[:, t], *ctx)
          X = dyn_b(X, Us_k[:, t], t, *ctx)
        cost = (cost + fc(X, *ctx)).reshape(E, K)
        return SimpleNamespace(U=rmpc.update(Us, eps_white, cost, config.smooth,
                                             config.temperature))

    def tf32_dyn(X, A, t, ctx=None):
      return dyn(X, A, ctx)[0]

    return tf32_dyn, mppi

  return rollout if driver == "rollouts" else mpc


def faults(p: dict, driver: str, kind: str):
  """The system with one fault planted: "unchanged" (the step returns the
  state it was given), "altered" (an answer moved by 0.1 where it is
  produced: each world's first joint velocity, and in the MPC cells also
  each environment's first action of the new plan) or "rare" (the first
  joint velocity moved by 3 in one world of every 64 alone: under a
  hundredth of the rows, which a percentile passes over, by twice the
  limit of the largest gap)."""
  rows, shift = (slice(None, None, 64), 3.0) if kind == "rare" else (slice(None), 0.1)

  def rollout(scene):
    from raisimlib_torch.ops import gpu_step

    step = gpu_step.make_step_batch_fused(scene)

    def bad(state, tau, pd, field_heights=None):
      if kind == "unchanged":
        return state
      s = step(state, tau, pd, field_heights=field_heights)
      u = s.u.clone()
      u[rows, 6] += shift
      return SimpleNamespace(q=s.q, u=u, t=s.t)

    return bad

  def mpc(scene, cell):
    from raisimlib_torch.mpc.mppi import mppi_step_batch

    dyn, mppi = cell.dyn, mppi_step_batch

    def bad_dyn(X, A, t, ctx=None):
      if kind == "unchanged":
        return X
      out = dyn(X, A, t, ctx).clone()
      out[rows, 19 + 6] += shift
      return out

    def bad_mppi(*a, **k):
      sol = mppi(*a, **k)
      if kind != "altered":
        return sol
      U = sol.U.clone()
      U[:, 0, 0] += 0.1
      return sol._replace(U=U)

    return bad_dyn, bad_mppi

  return rollout if driver == "rollouts" else mpc


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
  f = open(args.out, "a") if args.out else None
  try:
    for what, seed, sub in runs:
      t0 = time.perf_counter()
      out = execute(bench, args.workload, seed, args.seconds, trace=False, substitute=sub)
      rec = {"workload": args.workload, "run": what, "seed": seed, "correct": out["correct"],
             "checks": {n: c["value"] for n, c in out["checks"].items()},
             "metrics": {n: m["value"] for n, m in out["metrics"].items()},
             "seconds": time.perf_counter() - t0}
      print(json.dumps(rec), flush=True)
      if f:
        f.write(json.dumps(rec) + "\n")
        f.flush()
  finally:
    if f:
      f.close()
  return 0


if __name__ == "__main__":
  sys.exit(main())
