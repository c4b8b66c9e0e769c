"""Replay the sphere-box stack golden through each of the port's step paths,
float32.

Run from the repository root:

    python3 tools/stack_golden_gate.py [--device cpu|cuda]

tests/goldens/sphere_box_stack.npz (400 steps of the kicked box-and-sphere
stack) goes through the reference step (Scene.step), the K2 path
(Scene.step_batch: the solve kernel on the card, its twin on the CPU) and
the fused step K1b (the kernel on the card, its twin on the CPU). For each it
prints the largest |dq| against the golden, its step, and the resting
heights, and exits non-zero if a path breaks the stack gate of
raisimlib_torch/utils/parity.py. On the CPU the three take about 25 s, 70 s
and 100 s.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
  import torch

  import chip_smoke
  from raisimlib_torch.ops import gpu_step

  ap = argparse.ArgumentParser()
  ap.add_argument("--device", default="cpu")
  args = ap.parse_args()

  def fused(scene):
    step = gpu_step.make_step_batch_fused(scene, use_pd=False)
    return lambda s: step(s, torch.zeros_like(s.u))

  for label, step_for in (("Scene.step", chip_smoke.reference_step),
                          ("K2 path", lambda sc: lambda s: sc.step_batch(s)),
                          ("K1b", fused)):
    chip_smoke.stack_golden(torch, step_for, label, device=args.device)


if __name__ == "__main__":
  main()
