"""Configuration of the serving forward and the training step, as frozen
dataclasses.

The port keeps its own copy of the configuration schema of
`featurematching_tpu.config`, limited to the fields the serving forward and
the training step read. Field names and defaults are the same, so a
configuration of the JAX package converts with
`config_from_dict(Config, dataclasses.asdict(cfg))`. A field this copy does
not hold converts only at its JAX default, or where it never changes the
math (`IGNORED_JAX_FIELDS`): the model always has a qkv bias, a patch-embed
LayerNorm, a coarse-feature concat in its fine stage, and no positional
encoding, and a configuration asking otherwise raises.

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
    # the window-attention kernel (K11, `ops/window_attention`) in the per-op
    # block: 'auto' (evaluation on the card), 'on', 'off'
    fused_attention: str = "auto"
    # the differentiable fused block (K8, `ops/swin_block_train`) in the
    # training Matcher: 'auto', 'on', 'off'. Supersedes fused_attention
    # where it is selected
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
    # the coarse-only Matcher (no fine stage; the LoFTR-tiny teacher's mode)
    coarse_only: bool = False


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


def tpu_optimized_config() -> Config:
    """The JAX package's performance profile: the default's capacity with
    head dim 64 (Swin heads (1, 2, 4), coarse 4 heads, fine 1 head). Not
    weight-compatible with default_config()."""
    return Config(model=ModelConfig(
        swin=SwinConfig(num_heads=(1, 2, 4)),
        coarse=TransformerConfig(d_model=256, nhead=4),
        fine=FineMatchConfig(d_model=64, nhead=1),
    ))


# Fields of the JAX package's configuration that this copy does not hold,
# with the JAX defaults (by dotted path from the `Config` root). A value other
# than the default would build another model, so `config_from_dict` refuses it.
JAX_ONLY_DEFAULTS = {
    "model.positional_encoding": None,  # True adds the sine encoding
    "model.swin.qkv_bias": True,
    "model.swin.patch_norm": True,
    "model.fine.concat_coarse_feat": True,
}
# Fields this copy does not hold that never change the port's math, each
# with its reason; any value passes.
IGNORED_JAX_FIELDS = {
    "model.resnet_fpn": "read only by the ResNet-FPN backbone, which the port refuses",
    "model.pose": "read only by the pose heads; pose.flag other than 'none' raises",
    "model.loss.fine_correct_thr": "read by no code of the JAX package",
    "model.loss.r_weight": "a pose-head loss weight; the pose heads are not ported",
    "model.loss.t_weight": "a pose-head loss weight; the pose heads are not ported",
    "model.loss.pose_in_total": "a pose-head loss switch; the pose heads are not ported",
    "trainer.optimizer.scheduler_interval": "read by no code of the JAX package",
    "trainer.ransac": "the pose solver of evaluation, not part of the training step",
    "trainer.data_sampler": "the JAX package's data loading",
    "trainer.n_samples_per_subset": "the JAX package's data loading",
    "trainer.val_plot_pairs": "validation figures",
    "data": "the JAX package's dataset paths and loader sizes",
}


def _config_paths(cls: Any = Config, path: str = "") -> dict:
    """Each config class under `cls` by its dotted path prefix (its first
    place, walking the fields in order), read from the type hints."""
    paths = {cls: path}
    hints = typing.get_type_hints(cls)
    for f in dataclasses.fields(cls):
        if dataclasses.is_dataclass(hints[f.name]):
            for sub, p in _config_paths(hints[f.name], f"{path}{f.name}.").items():
                paths.setdefault(sub, p)
    return paths


def config_from_dict(cls: Any, d: dict, _path: str = None) -> Any:
    """Rebuild `cls` (and its nested config dataclasses) from a plain dict.

    Lists become tuples. A key `cls` has no field for passes only where it
    holds the JAX package's default (`JAX_ONLY_DEFAULTS`) or never changes
    the math (`IGNORED_JAX_FIELDS`); any other raises ValueError naming the
    field, so a JAX configuration never converts to another model."""
    if _path is None:  # a dict of a sub-config converts alone at its place in Config
        _path = _config_paths().get(cls, "")
    hints = typing.get_type_hints(cls)
    names = {f.name for f in dataclasses.fields(cls)}
    for key in d:
        if key in names:
            continue
        path = _path + key
        if any(path == p or path.startswith(p + ".") for p in IGNORED_JAX_FIELDS):
            continue
        v = d[key]
        if path not in JAX_ONLY_DEFAULTS or v != JAX_ONLY_DEFAULTS[path]:
            raise ValueError(
                f"config field {path}={v!r} is not held by the port: only the JAX default "
                f"{JAX_ONLY_DEFAULTS.get(path, '(none)')!r} converts")
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        t = hints[f.name]
        if dataclasses.is_dataclass(t) and isinstance(v, dict):
            v = config_from_dict(t, v, f"{_path}{f.name}.")
        elif isinstance(v, list):
            v = tuple(v)
        kwargs[f.name] = v
    return cls(**kwargs)
