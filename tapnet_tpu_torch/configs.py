"""Experiment configurations for training (port of tapnet_tpu/configs.py).

Typed dataclasses with the JAX package's hyperparameters. TAPIR
(`tapir_experiment`), TAP-Net (`tapnet_experiment`), causal TAPIR
(`causal_tapir_experiment`), BootsTAPIR (`bootstapir_experiment`) and
TAPNext (`tapnext_experiment`, `tapnextpp_experiment`) train.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

from tapnet_tpu_torch.models import ssm_vit
from tapnet_tpu_torch.models import tapir as tapir_lib
from tapnet_tpu_torch.models import tapnet as tapnet_lib
from tapnet_tpu_torch.training import optimizers, trainer


@dataclasses.dataclass(frozen=True)
class DataConfig:
  """The batches' shape, and the Kubric reader's augmentations (the
  synthetic data takes none)."""

  train_size: Tuple[int, int] = (256, 256)
  batch_size: int = 8
  num_queries: int = 256
  num_frames: int = 24
  color_augment: bool = True
  # TAPNext++ roll/homography camera-jitter augmentation
  # (reference tapnet/tapnextpp/augmentations/{roll,homography}.py).
  geometric_augment: bool = False


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
  name: str
  model_kind: str  # "tapir" | "tapnet" | "tapnext"
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
    if self.model_kind == "tapir":
      return tapir_lib.TAPIR(config=self.model_config)
    if self.model_kind == "tapnet":
      return tapnet_lib.TAPNet(config=self.model_config)
    if self.model_kind == "tapnext":
      from tapnet_tpu_torch.models import tapnext

      return tapnext.TAPNextTracker(config=self.model_config)
    raise ValueError(f"Unknown model kind {self.model_kind!r}")

  @property
  def loss_builder(self):
    """The loss for Trainer: TAPIR's and TAP-Net's is the TAP loss, as in
    the JAX package (whose property returns None, the Trainer's default,
    for both); `trainer.contrastive_loss_builder` is TAP-Net's other
    loss."""
    if self.model_kind in ("tapir", "tapnet"):
      return trainer.tapir_loss_builder
    if self.model_kind != "tapnext":
      raise ValueError(f"Unknown model kind {self.model_kind!r}")
    if self.train_time_chunk:
      return functools.partial(trainer.tapnext_chunked_loss_builder,
                               chunk_size=self.train_time_chunk)
    return trainer.tapnext_loss_builder


def tapir_experiment(**overrides) -> ExperimentConfig:
  """TAPIR training (reference configs/tapir_config.py:53-96: adam b1=.9
  b2=.95, lr 1e-3 cosine with 1k warmup, wd 0.1, no clipping, 100k steps,
  chunk 32)."""
  kwargs = dict(
      name="tapir",
      model_kind="tapir",
      model_config=tapir_lib.tapir_config(),
      optimizer=optimizers.OptimizerConfig(
          base_lr=1e-3, adam_b1=0.9, adam_b2=0.95, weight_decay=1e-1,
          warmup_steps=1000, max_norm=-1),
      task=trainer.TaskConfig(train_chunk_size=32),
      data=DataConfig(),
      total_steps=100_000,
  )
  kwargs.update(overrides)
  return ExperimentConfig(**kwargs)


def tapnet_experiment(**overrides) -> ExperimentConfig:
  """TAP-Net training (reference configs/tapnet_config.py:54-60: lr 2e-3,
  wd 1e-2, 5k warmup)."""
  kwargs = dict(
      name="tapnet",
      model_kind="tapnet",
      model_config=tapnet_lib.TapNetConfig(),
      optimizer=optimizers.OptimizerConfig(
          base_lr=2e-3, weight_decay=1e-2, warmup_steps=5000),
      task=trainer.TaskConfig(train_chunk_size=32),
      data=DataConfig(),
      total_steps=100_000,
  )
  kwargs.update(overrides)
  return ExperimentConfig(**kwargs)


def causal_tapir_experiment(**overrides) -> ExperimentConfig:
  """Causal TAPIR (reference configs/causal_tapir_config.py:78-79)."""
  return tapir_experiment(name="causal_tapir",
                          model_config=tapir_lib.causal_tapir_config(),
                          **overrides)


def bootstapir_experiment(**overrides) -> ExperimentConfig:
  """BootsTAPIR architecture (reference configs/tapir_bootstrap_config.py:
  76-83: extra convs, softmax temperature 10, pyramid level 1)."""
  return tapir_experiment(name="bootstapir",
                          model_config=tapir_lib.bootstapir_config(),
                          **overrides)


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
      data=DataConfig(num_frames=1024, num_queries=64, batch_size=1,
                      geometric_augment=True),
      train_time_chunk=128,
      total_steps=20_000,
      evaluate_every=2_000,
  )
  kwargs.update(overrides)
  return ExperimentConfig(**kwargs)


REGISTRY = {
    "tapir": tapir_experiment,
    "tapnet": tapnet_experiment,
    "causal_tapir": causal_tapir_experiment,
    "bootstapir": bootstapir_experiment,
    "tapnext": tapnext_experiment,
    "tapnextpp": tapnextpp_experiment,
}


def get_experiment(name: str, **overrides) -> ExperimentConfig:
  if name not in REGISTRY:
    raise ValueError(
        f"Unknown experiment {name!r}; choices: {sorted(REGISTRY)}")
  return REGISTRY[name](**overrides)
