"""Replay the trot golden through each of the port's step paths, float32.

Run from the repository root:

    python3 tools/trot_golden_gate.py [--device cpu|cuda]

tests/goldens/anymal_trot_heightmap.npz (80 steps of an open-loop trot on a
procedural heightfield) goes through the reference step (Scene.step), the K2
path (Scene.step_batch: the solve kernel on the card, its twin on the CPU)
and the fused step K1c (the kernel on the card, its twin on the CPU). For each
it prints the share of applied-torque entries within 1e-3 N m of the
golden's, the largest deviation and its step, and the largest |dq|, and
exits non-zero if a path breaks the trot gate of raisimlib_torch/utils/
parity.py. On the CPU the three take about 6 s, 16 s and 64 s.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
  import torch

  import chip_smoke
  from raisimlib_torch.ops import gpu_step
  from raisimlib_torch.ops.integrator import State

  ap = argparse.ArgumentParser()
  ap.add_argument("--device", default="cpu")
  args = ap.parse_args()

  def reference(scene):
    def step(s, pd):
      s1 = scene.step(State(q=s.q[0], u=s.u[0], t=s.t[0]), pd_target=pd[0])
      return State(q=s1.q[None], u=s1.u[None], t=s1.t[None])
    return step

  def fused(scene):
    step = gpu_step.make_step_batch_fused(scene)
    return lambda s, pd: step(s, torch.zeros_like(pd), pd)

  for label, step_for in (("Scene.step", reference),
                          ("K2 path", lambda sc: lambda s, pd: sc.step_batch(s, pd_target=pd)),
                          ("K1c", fused)):
    chip_smoke.trot_golden(torch, step_for, label, device=args.device)


if __name__ == "__main__":
  main()
