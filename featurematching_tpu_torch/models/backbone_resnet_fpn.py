"""ResNet-FPN backbone (1/8 coarse + 1/2 fine), NHWC at its edges.

Port of `featurematching_tpu/models/backbone_resnet_fpn.py` (BasicBlock,
ResNetFPN, `_upsample2x`): a 7x7 stride-2 stem, three stages of two basic
blocks (strides 1, 2, 2), then the top-down FPN from 1/8 to 1/2 with
bilinear x2 upsampling (align_corners) and 3x3 smoothing. The submodules
carry the flax tree's names, so `utils/weights.load_jax_params` loads a
flax `params` / `batch_stats` pair into it.

The convolutions are `F.conv2d` with the flax padding (explicit symmetric
k // 2 for the stem and the blocks, pad 1 for the FPN's 3x3 'SAME', none for
the 1x1), computed outside any TPU kernel in the JAX package, so cuDNN runs
them here, inside `torch.backends.cudnn.flags(allow_tf32=False,
benchmark=True)`: cuDNN takes a float32 convolution in TF32 by default
(`torch.backends.cudnn.allow_tf32`), so the forward turns that off for its
own convolutions, and it times cuDNN's algorithms once a shape
(`benchmark`, as XLA autotunes its convolutions): without that, cuDNN's
heuristics picked for the float32 stem of one 480x640 pair an FFT-tiled
algorithm of 99,072 small complex products, 1.07 s on an H100 against 0.1 s
for four pairs. The caller's settings are restored after the forward.
BatchNorm reads its running statistics
(evaluation; flax's eps 1e-5). Weights are held in float32 and cast to the
activation dtype at use, as flax does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from featurematching_tpu_torch.config import ModelConfig

BN_EPS = 1e-5  # flax nn.BatchNorm's epsilon
BN_MOMENTUM = 0.1  # flax's momentum 0.9 as torch counts it (unused in evaluation)
LEAKY_SLOPE = 0.01


def _bn(dim: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(dim, eps=BN_EPS, momentum=BN_MOMENTUM)


def _conv(dim_in: int, dim_out: int, k: int) -> nn.Conv2d:
    return nn.Conv2d(dim_in, dim_out, k, bias=False)


def conv(x: torch.Tensor, layer: nn.Conv2d, stride: int = 1) -> torch.Tensor:
    """x [B, C, H, W] through `layer`'s weight in x's dtype, stride `stride`,
    symmetric padding k // 2 (flax's explicit padding for the stem and the
    blocks, and 'SAME' for the FPN's stride-1 3x3; none for 1x1)."""
    k = layer.kernel_size[0]
    return F.conv2d(x, layer.weight.to(x.dtype), stride=stride, padding=k // 2)


def batch_norm(x: torch.Tensor, layer: nn.BatchNorm2d) -> torch.Tensor:
    """Evaluation BatchNorm of x [B, C, H, W] from the running statistics."""
    dt = x.dtype
    return F.batch_norm(x, layer.running_mean.to(dt), layer.running_var.to(dt),
                        layer.weight.to(dt), layer.bias.to(dt), False, 0.0, layer.eps)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Bilinear x2 of x [B, C, H, W] with align_corners=True; a side of 1
    repeats its one row or column, as the JAX gather does."""
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)


class BasicBlock(nn.Module):
    """Two 3x3 convolutions with BatchNorm and a residual; a 1x1 stride-s
    convolution with BatchNorm on the residual where the stride is not 1."""

    def __init__(self, dim_in: int, planes: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.conv1 = _conv(dim_in, planes, 3)
        self.bn1 = _bn(planes)
        self.conv2 = _conv(planes, planes, 3)
        self.bn2 = _bn(planes)
        if stride != 1:
            self.down = _conv(dim_in, planes, 1)
            self.bn_down = _bn(planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(batch_norm(conv(x, self.conv1, self.stride), self.bn1))
        y = batch_norm(conv(y, self.conv2), self.bn2)
        if self.stride != 1:
            x = batch_norm(conv(x, self.down, self.stride), self.bn_down)
        return torch.relu(x + y)


class ResNetFPN(nn.Module):
    """Outputs (coarse [B, H/8, W/8, block_dims[2]], fine [B, H/2, W/2,
    block_dims[0]]) from x [B, H, W, C_in] (NHWC)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        r = cfg.resnet_fpn
        d0, d1, d2 = r.block_dims
        self.conv1 = nn.Conv2d(cfg.input_channels, r.initial_dim, 7, bias=False)
        self.bn1 = _bn(r.initial_dim)
        dim = r.initial_dim
        for name, planes, stride in (("layer1", d0, 1), ("layer2", d1, 2), ("layer3", d2, 2)):
            self.add_module(f"{name}_0", BasicBlock(dim, planes, stride))
            self.add_module(f"{name}_1", BasicBlock(planes, planes, 1))
            dim = planes
        self.layer3_outconv = _conv(d2, d2, 1)
        self.layer2_outconv = _conv(d1, d2, 1)
        self.layer2_outconv2_a = _conv(d2, d2, 3)
        self.layer2_bn = _bn(d2)
        self.layer2_outconv2_b = _conv(d2, d1, 3)
        self.layer1_outconv = _conv(d0, d1, 1)
        self.layer1_outconv2_a = _conv(d1, d1, 3)
        self.layer1_bn = _bn(d1)
        self.layer1_outconv2_b = _conv(d1, d0, 3)

    def _stage(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return getattr(self, f"{name}_1")(getattr(self, f"{name}_0")(x))

    def _smooth(self, lateral: torch.Tensor, top: torch.Tensor, level: str) -> torch.Tensor:
        """One top-down level: lateral + upsampled top, 3x3, BN, leaky ReLU, 3x3."""
        y = lateral + upsample2x(top)
        y = batch_norm(conv(y, getattr(self, f"{level}_outconv2_a")), getattr(self, f"{level}_bn"))
        return conv(F.leaky_relu(y, LEAKY_SLOPE), getattr(self, f"{level}_outconv2_b"))

    def forward(self, x: torch.Tensor,
                fine: bool = True) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """x: [B, H, W, C_in] in the compute dtype; evaluation only (the
        running statistics). `fine=False` stops at the coarse output (the
        coarse-only Matcher reads no fine map; XLA drops that branch of the
        JAX program likewise) and returns None for it."""
        cudnn = torch.backends.cudnn
        with cudnn.flags(enabled=cudnn.enabled, benchmark=True,
                         deterministic=cudnn.deterministic, allow_tf32=False):
            x0 = torch.relu(batch_norm(conv(x.permute(0, 3, 1, 2), self.conv1, 2), self.bn1))
            x1 = self._stage(x0, "layer1")  # 1/2
            x2 = self._stage(x1, "layer2")  # 1/4
            x3 = self._stage(x2, "layer3")  # 1/8
            x3_out = conv(x3, self.layer3_outconv)
            coarse = x3_out.permute(0, 2, 3, 1)
            if not fine:
                return coarse, None
            x2_out = self._smooth(conv(x2, self.layer2_outconv), x3_out, "layer2")
            x1_out = self._smooth(conv(x1, self.layer1_outconv), x2_out, "layer1")
        return coarse, x1_out.permute(0, 2, 3, 1)
