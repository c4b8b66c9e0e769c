"""Run chip_smoke.py's phase 25, the 1 s drop of the debris scenes, on the
CPU through the generated fused-step bodies compiled as host C++.

Run from the repository root (needs g++):

    python3 tools/debris_drop_cpu.py [--worlds 16384] [--steps 500]
                                     [--shapes cylinder,cone,mesh]

Each debris scene (one loose cylinder, cone or 32-vertex rock per world on
the 64 fractal terrains of chip_smoke.make_terrains) drops from
chip_smoke.debris_states (seed 23) and runs `--steps` steps through its K1c
body (gpu_step.kernel_source, compiled as host C++ without FMA contraction:
the kernel's arithmetic, one world after another). It prints phase 25's
gates for each scene, and for each world whose deepest probe is 5 mm deep
or more at the last step, that depth and the body's angular speed. It exits
non-zero if a world fails a gate. A scene of 16,384 worlds takes about 6-8
minutes on one core. The host build goes to raisimlib_torch/_build/host/.
"""

import argparse
import os
import pathlib
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))


def main():
  import numpy as np
  import torch

  import chip_smoke as cs
  from raisimlib_torch.ops import gpu_step
  from raisimlib_torch.ops.integrator import State
  from torch_port_util import host_step

  ap = argparse.ArgumentParser()
  ap.add_argument("--worlds", type=int, default=16384)
  ap.add_argument("--steps", type=int, default=500)
  ap.add_argument("--shapes", default=",".join(cs.DEBRIS_NAMES))
  args = ap.parse_args()

  B = args.worlds
  hts = cs.make_terrains(torch, 64, device="cpu").repeat((B + 63) // 64, 1, 1)[:B].contiguous()
  H = np.ascontiguousarray(hts.numpy(), np.float32)
  failed = False
  for name in args.shapes.split(","):
    scene = cs.debris_scene(torch, name, device="cpu")
    sd = gpu_step.make_step_batch_fused(scene, use_pd=False).sd
    build = pathlib.Path(REPO, "raisimlib_torch", "_build", "host", name)
    build.mkdir(parents=True, exist_ok=True)
    host = host_step(sd, build)
    zeros = np.zeros((B, sd.nv), np.float32)

    def step(s):
      q, u = s.q.numpy().copy(), s.u.numpy().copy()
      qo, uo = np.zeros_like(q), np.zeros_like(u)
      host(q.ctypes.data, u.ctypes.data, zeros.ctypes.data, zeros.ctypes.data, H.ctypes.data,
           H[0].size, qo.ctypes.data, uo.ctypes.data, B)
      return State(q=torch.from_numpy(qo), u=torch.from_numpy(uo), t=s.t)

    t0 = time.perf_counter()
    gates, bad, s, depth = cs.settle_gates(torch, scene, step, cs.debris_states(torch, scene, hts, 23),
                                           hts, args.steps)
    print(f"{name}: {B} worlds x {args.steps} steps in {time.perf_counter() - t0:.1f} s; {gates}",
          flush=True)
    for w in np.flatnonzero(depth.numpy() >= 5e-3):
      print(f"  world {w}: deepest probe {1e3 * float(depth[w]):.2f} mm, angular speed "
            f"{float(s.u[w, :3].norm()):.2f} rad/s")
    failed |= bool(bad.any())
  sys.exit(1 if failed else 0)


if __name__ == "__main__":
  main()
