"""Weights of the port's modules: a seeded init, and the crossing to and
from a flax tree.

The port's modules name their submodules after the JAX param tree
(`backbone.enc0_blk0.attn.qkv`, `coarse_transformer.layer_3.merge`,
`fine_down_proj`, `mix_feat_0`, ...), so a flax leaf `a/b/kernel` is the
parameter `a.b.weight`, and the walk is mechanical in both directions
(`load_jax_params`, `to_jax_tree`).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

# flax leaf name -> torch parameter name
_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias", "rel_pos_bias": "rel_pos_bias"}


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v, dtype=np.float32)
    return out


def load_jax_params(module: nn.Module, params: Mapping) -> None:
    """Copy a flax `variables["params"]` tree (nested dicts of arrays) into
    `module`. Dense kernels [in, out] become weights [out, in]; conv kernels
    HWIO become OIHW; LN scale/bias become weight/bias; rel_pos_bias tables
    copy as they are. Raises on a leaf with no parameter, a parameter with no
    leaf, or a shape mismatch."""
    targets = dict(module.named_parameters())
    seen = set()
    with torch.no_grad():
        for path, arr in _flatten(params).items():
            *mods, leaf = path.split("/")
            if leaf not in _LEAF:
                raise KeyError(f"unknown flax leaf {path!r}")
            name = ".".join(mods + [_LEAF[leaf]])
            if name not in targets:
                raise KeyError(f"flax leaf {path!r} has no parameter {name!r}")
            t = torch.tensor(arr)
            if leaf == "kernel":
                t = t.permute(3, 2, 0, 1) if t.ndim == 4 else t.t()
            p = targets[name]
            if tuple(p.shape) != tuple(t.shape):
                raise ValueError(f"{name}: shape {tuple(p.shape)} vs flax {tuple(t.shape)}")
            p.copy_(t)
            seen.add(name)
    missing = sorted(set(targets) - seen)
    if missing:
        raise KeyError(f"parameters with no flax leaf: {missing}")


def to_jax_tree(module: nn.Module, grads: bool = False) -> Dict:
    """`module`'s parameters (or, with `grads`, their `.grad`) as a flax
    `params` tree of float32 numpy arrays: the inverse of `load_jax_params`
    (weights [out, in] become Dense kernels [in, out], OIHW conv weights HWIO
    kernels, LayerNorm weights `scale`)."""
    tree: Dict = {}
    for name, p in module.named_parameters():
        owner_name, _, leaf = name.rpartition(".")
        owner = module.get_submodule(owner_name)
        t = p.grad if grads else p
        if t is None:
            raise ValueError(f"{name} has no gradient")
        arr = t.detach().float().cpu()
        if leaf == "weight" and isinstance(owner, nn.LayerNorm):
            flax_leaf = "scale"
        elif leaf == "weight":
            flax_leaf = "kernel"
            arr = arr.permute(2, 3, 1, 0) if arr.ndim == 4 else arr.t()
        else:
            flax_leaf = leaf
        node = tree
        for m in owner_name.split("."):
            node = node.setdefault(m, {})
        node[flax_leaf] = arr.contiguous().numpy()
    return tree


def _trunc_normal(p: torch.Tensor, std: float, g: torch.Generator) -> None:
    nn.init.trunc_normal_(p, 0.0, std, -2.0 * std, 2.0 * std, generator=g)


def init_weights(module: nn.Module, seed: int) -> None:
    """Seeded init with the JAX package's initializers: truncated
    lecun-normal dense and conv kernels, zero biases, unit LN scales, and
    rel_pos_bias tables truncated normal with std 0.02."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            owner_name, _, leaf = name.rpartition(".")
            owner = module.get_submodule(owner_name)
            if leaf == "rel_pos_bias":
                _trunc_normal(p, 0.02, g)
            elif leaf == "bias":
                p.zero_()
            elif isinstance(owner, nn.LayerNorm):
                p.fill_(1.0)
            else:
                # variance 1/fan_in after truncation at two std (flax's lecun_normal)
                _trunc_normal(p, (1.0 / p[0].numel()) ** 0.5 / 0.8796256610342398, g)
