"""Configuration of the serving forward, as frozen dataclasses.

The port keeps its own copy of the configuration schema of
`featurematching_tpu.config`, limited to the fields the serving forward
reads. Field names and defaults are the same, so a configuration of the JAX
package converts with `config_from_dict(ModelConfig, dataclasses.asdict(cfg))`
(fields this copy does not hold are ignored). The forward always has a qkv
bias, a patch-embed LayerNorm and the fine stage's coarse-feature concat, the
JAX defaults; a weight tree without them fails to load.
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


@dataclass(frozen=True)
class TransformerConfig:
    """LoFTR linear-attention transformer stack."""

    d_model: int = 256
    nhead: int = 8
    layer_names: Tuple[str, ...] = ("self", "cross") * 4
    attention: str = "linear"


@dataclass(frozen=True)
class CoarseMatchConfig:
    """Dual-softmax coarse matching with a static top-K match list."""

    thr: float = 0.20
    border_rm: int = 2
    dsmax_temperature: float = 0.1
    max_matches: int = 1024


@dataclass(frozen=True)
class FineMatchConfig:
    """Fine window refinement."""

    window_size: int = 7  # must be odd
    d_model: int = 64
    nhead: int = 8
    layer_names: Tuple[str, ...] = ("self", "cross")
    attention: str = "linear"


@dataclass(frozen=True)
class ModelConfig:
    backbone_type: str = "swin_v1"
    input_channels: int = 3
    resolution: Tuple[int, int] = (8, 2)  # (coarse, fine) strides
    swin: SwinConfig = field(default_factory=SwinConfig)
    coarse: TransformerConfig = field(default_factory=TransformerConfig)
    match_coarse: CoarseMatchConfig = field(default_factory=CoarseMatchConfig)
    fine: FineMatchConfig = field(default_factory=FineMatchConfig)
    compute_dtype: str = "bfloat16"


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)


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
