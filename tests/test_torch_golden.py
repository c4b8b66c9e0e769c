"""The port replays the frozen f64 ANYmal balance golden in f32
(tests/goldens/anymal_balance.npz: 50 steps from the settled q0/u0, lateral
push, sinusoidal knee targets) — the torque-parity gate of tests/test_parity.py
applied to the port. The reference step is held here, the batched step in
tests/test_torch_golden_batch.py; the gates live in
raisimlib_torch/utils/parity.py, which chip_smoke.py applies on the card."""

import numpy as np
import torch

from torch_port_util import load_golden, torch_anymal_scene


def _replay(batched):
  g = load_golden()
  scene = torch_anymal_scene(torch.float32, kp=float(g["kp"]), kd=float(g["kd"]))
  qs, us = [], []
  with torch.inference_mode():
    if batched:
      s = scene.init_state(q=g["q0"][None], u=g["u0"][None])
      for tgt in g["pd_targets"]:
        s = scene.step_batch(s, pd_target=torch.tensor(tgt[None], dtype=torch.float32))
        qs.append(s.q[0].numpy())
        us.append(s.u[0].numpy())
    else:
      s = scene.init_state(q=g["q0"], u=g["u0"])
      for tgt in g["pd_targets"]:
        s = scene.step(s, pd_target=torch.tensor(tgt, dtype=torch.float32))
        qs.append(s.q.numpy())
        us.append(s.u.numpy())
  return np.stack(qs), np.stack(us), g


def test_scene_step_replays_golden_f32():
  """The reference step: 1e-3 N m on the torque, 1e-4 on q, all 50 steps."""
  from raisimlib_torch.utils import parity

  qs, us, g = _replay(batched=False)
  assert not parity.reference_gate_failures(qs, us, g), \
      parity.reference_gate_failures(qs, us, g)
