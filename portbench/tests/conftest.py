"""The benchmark's own tests: run from the repository's root with
`python3 -m pytest portbench/tests -q`. They import no JAX."""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
  sys.path.insert(0, ROOT)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
  """One intra-op thread: the workers of a test run share the cores."""
  n = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(n)
