"""Configuration of the serving forward and the training step, as frozen
dataclasses.

The port keeps its own copy of the configuration schema of
`featurematching_tpu.config`, limited to the fields the serving forward and
the training step read. Field names and defaults are the same, so a
configuration of the JAX package converts with
`config_from_dict(Config, dataclasses.asdict(cfg))` (fields this copy does
not hold are ignored). The model always has a qkv bias, a patch-embed
LayerNorm and the fine stage's coarse-feature concat, the JAX defaults; a
weight tree without them fails to load.

The kernel switches mean what they mean in the JAX package: 'on' runs the
kernel, 'off' the per-op form, 'auto' the kernel on an accelerator (`cuda`
here) and the per-op form on the CPU. On the CPU a kernel wrapper runs its
plain twin, so 'on' there computes the kernel's function in plain PyTorch.
"""

from __future__ import annotations

import dataclasses
import typing
from dataclasses import dataclass, field
from typing import Any, Tuple


@dataclass(frozen=True)
class SwinConfig:
    """Swin-T U-Net backbone dims."""

    patch_size: int = 4
    embed_dim: int = 64
    depths: Tuple[int, ...] = (2, 2, 6)
    depths_up: Tuple[int, ...] = (1, 1, 1)
    num_heads: Tuple[int, ...] = (4, 8, 16)
    window_size: int = 8
    mlp_ratio: float = 4.0
    drop_path_rate: float = 0.2
    # the differentiable fused block (K8, `ops/swin_block_train`) in the
    # training Matcher: 'auto', 'on', 'off'
    fused_block: str = "auto"


@dataclass(frozen=True)
class TransformerConfig:
    """LoFTR linear-attention transformer stack."""

    d_model: int = 256
    nhead: int = 8
    layer_names: Tuple[str, ...] = ("self", "cross") * 4
    attention: str = "linear"
    # the differentiable fused stack (K9) in the training Matcher
    fused_train: str = "auto"


@dataclass(frozen=True)
class CoarseMatchConfig:
    """Dual-softmax coarse matching with a static top-K match list."""

    thr: float = 0.20
    border_rm: int = 2
    dsmax_temperature: float = 0.1
    max_matches: int = 1024
    max_gt_matches: int = 1024  # GT pairs a pair in training (fine windows)


@dataclass(frozen=True)
class FineMatchConfig:
    """Fine window refinement."""

    window_size: int = 7  # must be odd
    d_model: int = 64
    nhead: int = 8
    layer_names: Tuple[str, ...] = ("self", "cross")
    attention: str = "linear"
    # the differentiable fused window transformer (K10) in the training Matcher
    fused_train: str = "auto"


@dataclass(frozen=True)
class PoseHeadConfig:
    """Pose heads: only 'none' is ported."""

    flag: str = "none"


@dataclass(frozen=True)
class LossConfig:
    coarse_type: str = "focal"  # 'focal' | 'cross_entropy'
    coarse_weight: float = 1.0
    sparse_spvs: bool = True
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    pos_weight: float = 1.0
    neg_weight: float = 1.0
    fine_weight: float = 1.0


@dataclass(frozen=True)
class ModelConfig:
    backbone_type: str = "swin_v1"
    input_channels: int = 3
    resolution: Tuple[int, int] = (8, 2)  # (coarse, fine) strides
    swin: SwinConfig = field(default_factory=SwinConfig)
    coarse: TransformerConfig = field(default_factory=TransformerConfig)
    match_coarse: CoarseMatchConfig = field(default_factory=CoarseMatchConfig)
    fine: FineMatchConfig = field(default_factory=FineMatchConfig)
    pose: PoseHeadConfig = field(default_factory=PoseHeadConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    compute_dtype: str = "bfloat16"


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"  # 'adam' | 'adamw'
    canonical_bs: int = 64
    canonical_lr: float = 6e-3
    adam_decay: float = 0.0
    adamw_decay: float = 0.1
    warmup_type: str = "linear"  # 'linear' | 'constant'
    warmup_ratio: float = 0.0
    warmup_steps: int = 4800
    scheduler: str = "multistep"  # 'multistep' | 'cosine' | 'exponential'
    mslr_milestones: Tuple[int, ...] = (3, 6, 9, 12, 15, 18, 21, 24, 27)
    mslr_gamma: float = 0.5
    cosa_tmax: int = 30
    elr_gamma: float = 0.999992
    gradient_clipping: float = 0.5


@dataclass(frozen=True)
class TrainerConfig:
    seed: int = 114514
    batch_size: int = 4
    steps_per_epoch: int = 1000
    num_epochs: int = 30
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    trainer: TrainerConfig = field(default_factory=TrainerConfig)


def default_config() -> Config:
    return Config()


def config_from_dict(cls: Any, d: dict) -> Any:
    """Rebuild `cls` (and its nested config dataclasses) from a plain dict.

    Keys that `cls` has no field for are ignored; lists become tuples."""
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        t = hints[f.name]
        if dataclasses.is_dataclass(t) and isinstance(v, dict):
            v = config_from_dict(t, v)
        elif isinstance(v, list):
            v = tuple(v)
        kwargs[f.name] = v
    return cls(**kwargs)
