"""raisimlib_torch — the PyTorch + CUDA port of raisimlib_tpu for NVIDIA Hopper.

Same module layout as the JAX package, PyTorch idiom inside: dataclasses for
models, scenes and states; plain functions on tensors with an explicit leading
batch dimension where the JAX package uses `vmap`; Python loops where it uses
`lax.scan`/`fori_loop`; an explicit device everywhere. The contact solver's
TPU kernel is a hand-written CUDA kernel (`csrc/`, bound in
`ops/gpu_contact.py`). The package imports torch and numpy only.
"""

__version__ = "0.1.0"

from raisimlib_torch.models.model import JointType, RobotModel  # noqa: F401
from raisimlib_torch.world import Scene, World  # noqa: F401
