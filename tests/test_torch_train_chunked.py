"""PyTorch port, TAPNext training through time chunks with the SSM state
carried (`tapnext_chunked_loss_builder`, chunks of 2 frames): the train
step against the JAX package's in loss, every gradient leaf and the
parameters after 3 optimizer steps, and remat. Kept apart from
tests/test_torch_train_step.py (whose helpers it uses) so that the two JAX
compilations run on separate test workers.
"""

import os
import sys

import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_train_step as train_step  # noqa: E402

from tapnet_tpu_torch.training import trainer  # noqa: E402


def test_chunked_train_step_matches_jax():
  train_step.check_against_jax("chunked")


def test_chunked_remat_leaves_gradients_unchanged():
  train_step.assert_same(train_step.remat_gradients(
      lambda m, t: trainer.tapnext_chunked_loss_builder(m, t, chunk_size=2)))
