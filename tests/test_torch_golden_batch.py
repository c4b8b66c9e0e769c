"""The port's batched step replays the ANYmal balance golden in f32
(tests/goldens/anymal_balance.npz) and holds the batched path's gate, which
chip_smoke.py applies on the card (raisimlib_torch/utils/parity.py)."""

from test_torch_golden import _replay

from torch_port_util import one_thread  # noqa: F401  (a module fixture)


def test_step_batch_replays_golden_f32():
  """The batched step (the kernel's plain twin on the CPU): the reference gate
  for the first 15 steps, then the measured ceiling of the TPU kernel's
  algorithm (utils/parity.py explains the contact-branch flip at step ~19)."""
  from raisimlib_torch.utils import parity

  qs, us, g = _replay(batched=True)
  assert not parity.batch_gate_failures(qs, us, g), parity.batch_gate_failures(qs, us, g)
  dtau, _ = parity.golden_deviation(qs, us, g)
  assert dtau[:parity.BATCH_TIGHT_STEPS].max() < 1e-4     # measured 6.0e-5
