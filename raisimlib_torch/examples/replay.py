"""Offline trajectory viewer: renders a recorded .npz rollout to a PNG.

Counterpart of examples/replay.py. RaiSim's viewer is a live TCP client
(RaisimServer -> Unity/Ogre); here recorded trajectory files are replayed
instead, off the compute path. Needs matplotlib.

    python3 -m raisimlib_torch.examples.replay metrics/torch/anymal_trot_traj.npz -o trot.png
"""

from __future__ import annotations

import argparse


def main(argv=None) -> str:
  ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  ap.add_argument("traj", help=".npz written by utils/trajectory.save")
  ap.add_argument("-o", "--out", default=None, help="output PNG (default: <traj>.png)")
  ap.add_argument("--stride", type=int, default=10)
  args = ap.parse_args(argv)

  from raisimlib_torch.utils import trajectory

  traj = trajectory.load(args.traj)
  out = args.out or (args.traj.rsplit(".", 1)[0] + ".png")
  trajectory.render_matplotlib(traj, out, stride=args.stride)
  T, nb, _ = traj["body_pos"].shape
  print(f"rendered {T} frames x {nb} bodies -> {out}")
  return out


if __name__ == "__main__":
  main()
