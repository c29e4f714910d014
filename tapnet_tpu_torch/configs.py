"""Experiment configurations for training (port of tapnet_tpu/configs.py).

Typed dataclasses with the JAX package's hyperparameters. TAPNext
(`tapnext_experiment`, `tapnextpp_experiment`) trains; the TAPIR-family
experiments (tapir, tapnet, causal_tapir, bootstapir) raise
NotImplementedError until their training is ported (ROADMAP Queue 1 item
8).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

from tapnet_tpu_torch.models import ssm_vit
from tapnet_tpu_torch.training import optimizers, trainer


@dataclasses.dataclass(frozen=True)
class DataConfig:
  """The batches' shape. The JAX package's augmentation flags come with the
  Kubric training reader (not ported yet): the synthetic data has none."""

  train_size: Tuple[int, int] = (256, 256)
  batch_size: int = 8
  num_queries: int = 256
  num_frames: int = 24


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
  name: str
  model_kind: str  # "tapnext" (the kinds the port trains)
  model_config: object
  optimizer: optimizers.OptimizerConfig
  task: trainer.TaskConfig
  data: DataConfig
  total_steps: int
  # In-train held-out evaluation period (steps), when an eval set is given.
  evaluate_every: int = 10_000
  # Train through time-chunked forward_step passes with torch.utils
  # .checkpoint on each chunk (full BPTT through the carried SSM state).
  train_time_chunk: Optional[int] = None

  def build_model(self):
    if self.model_kind == "tapnext":
      from tapnet_tpu_torch.models import tapnext

      return tapnext.TAPNextTracker(config=self.model_config)
    raise ValueError(f"Unknown model kind {self.model_kind!r}")

  @property
  def loss_builder(self):
    """The loss for Trainer."""
    if self.model_kind != "tapnext":
      raise ValueError(f"Unknown model kind {self.model_kind!r}")
    if self.train_time_chunk:
      return functools.partial(trainer.tapnext_chunked_loss_builder,
                               chunk_size=self.train_time_chunk)
    return trainer.tapnext_loss_builder


def tapnext_experiment(variant: str = "B", **overrides) -> ExperimentConfig:
  """TAPNext (TRecViT-B by default)."""
  kwargs = dict(
      name=f"tapnext_{variant}",
      model_kind="tapnext",
      model_config=ssm_vit.variant_config(variant),
      optimizer=optimizers.OptimizerConfig(
          base_lr=1e-3, weight_decay=1e-1, warmup_steps=1000),
      task=trainer.TaskConfig(),
      data=DataConfig(num_queries=128),
      total_steps=200_000,
  )
  kwargs.update(overrides)
  return ExperimentConfig(**kwargs)


def tapnextpp_experiment(variant: str = "B", **overrides) -> ExperimentConfig:
  """TAPNext++ long-video fine-tune recipe: 1024-frame clips, batch 1,
  per-layer remat, a fine-tune learning rate with short warmup, trained
  through 128-frame chunks with the SSM state carried (full BPTT). The JAX
  preset's geometric augmentation comes with the Kubric reader."""
  kwargs = dict(
      name=f"tapnextpp_{variant}",
      model_kind="tapnext",
      model_config=ssm_vit.variant_config(variant, remat=True),
      optimizer=optimizers.OptimizerConfig(
          base_lr=1e-4, weight_decay=1e-1, warmup_steps=500),
      task=trainer.TaskConfig(),
      data=DataConfig(num_frames=1024, num_queries=64, batch_size=1),
      train_time_chunk=128,
      total_steps=20_000,
      evaluate_every=2_000,
  )
  kwargs.update(overrides)
  return ExperimentConfig(**kwargs)


def _not_ported(name):
  def make(**overrides):
    raise NotImplementedError(
        f"{name} training is not ported yet (ROADMAP Queue 1 item 8); the "
        "port trains tapnext and tapnextpp")
  return make


REGISTRY = {
    "tapir": _not_ported("tapir"),
    "tapnet": _not_ported("tapnet"),
    "causal_tapir": _not_ported("causal_tapir"),
    "bootstapir": _not_ported("bootstapir"),
    "tapnext": tapnext_experiment,
    "tapnextpp": tapnextpp_experiment,
}


def get_experiment(name: str, **overrides) -> ExperimentConfig:
  if name not in REGISTRY:
    raise ValueError(
        f"Unknown experiment {name!r}; choices: {sorted(REGISTRY)}")
  return REGISTRY[name](**overrides)
