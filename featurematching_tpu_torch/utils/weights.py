"""Weights of the port's modules: a seeded init, and the crossing to and
from a flax tree.

The port's modules name their submodules after the JAX param tree
(`backbone.enc0_blk0.attn.qkv`, `coarse_transformer.layer_3.merge`,
`fine_down_proj`, `mix_feat_0`, ...), so a flax leaf `a/b/kernel` is the
parameter `a.b.weight`, and the walk is mechanical in both directions
(`load_jax_params`, `to_jax_tree`). BatchNorm's running statistics are the
flax `batch_stats` collection: `a/b/mean` and `a/b/var` are the buffers
`a.b.running_mean` and `a.b.running_var`.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

# flax leaf name -> torch parameter name
_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias", "rel_pos_bias": "rel_pos_bias"}
# flax batch_stats leaf name -> torch BatchNorm buffer name
_STAT = {"mean": "running_mean", "var": "running_var"}


def flatten_tree(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """A nested dict of arrays as {"a/b/leaf": float32 array}."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(flatten_tree(v, path))
        else:
            out[path] = np.asarray(v, dtype=np.float32)
    return out


def _stat_buffers(module: nn.Module) -> Dict[str, torch.Tensor]:
    """Every BatchNorm running statistic of `module`, by its dotted name."""
    return {f"{name}.{buf}" if name else buf: getattr(m, buf)
            for name, m in module.named_modules() if isinstance(m, nn.modules.batchnorm._BatchNorm)
            for buf in _STAT.values()}


def load_jax_params(module: nn.Module, params: Mapping,
                    batch_stats: Optional[Mapping] = None) -> None:
    """Copy a flax `variables["params"]` tree (nested dicts of arrays) into
    `module`, and its `variables["batch_stats"]` into the BatchNorm running
    statistics. Dense kernels [in, out] become weights [out, in]; conv
    kernels HWIO become OIHW; LN and BN scale/bias become weight/bias; BN
    mean/var become running_mean/running_var; rel_pos_bias tables copy as
    they are. Raises on a leaf with no parameter or statistic, a parameter
    or statistic with no leaf (a module with BatchNorm needs `batch_stats`),
    or a shape mismatch."""
    targets = dict(module.named_parameters())
    stats = _stat_buffers(module)
    seen = set()
    leaves = [(item, _LEAF, targets) for item in flatten_tree(params).items()]
    leaves += [(item, _STAT, stats) for item in flatten_tree(batch_stats or {}).items()]
    with torch.no_grad():
        for (path, arr), names, dest in leaves:
            *mods, leaf = path.split("/")
            if leaf not in names:
                raise KeyError(f"unknown flax leaf {path!r}")
            name = ".".join(mods + [names[leaf]])
            if name not in dest:
                raise KeyError(f"flax leaf {path!r} has no parameter or statistic {name!r}")
            t = torch.tensor(arr)
            if leaf == "kernel":
                t = t.permute(3, 2, 0, 1) if t.ndim == 4 else t.t()
            p = dest[name]
            if tuple(p.shape) != tuple(t.shape):
                raise ValueError(f"{name}: shape {tuple(p.shape)} vs flax {tuple(t.shape)}")
            p.copy_(t)
            seen.add(name)
    missing = sorted((set(targets) | set(stats)) - seen)
    if missing:
        raise KeyError(f"parameters or statistics with no flax leaf: {missing}")


def to_jax_tree(module: nn.Module, grads: bool = False, batch_stats: bool = False) -> Dict:
    """`module`'s parameters (or, with `grads`, their `.grad`) as a flax
    `params` tree of float32 numpy arrays: the inverse of `load_jax_params`
    (weights [out, in] become Dense kernels [in, out], OIHW conv weights HWIO
    kernels, LayerNorm and BatchNorm weights `scale`). With `batch_stats`,
    the BatchNorm running statistics as a flax `batch_stats` tree instead
    (`mean`, `var`; empty for a module without BatchNorm)."""
    tree: Dict = {}
    if batch_stats:
        leaf_of = {v: k for k, v in _STAT.items()}
        items = list(_stat_buffers(module).items())
    else:
        items = list(module.named_parameters())
    for name, p in items:
        owner_name, _, leaf = name.rpartition(".")
        owner = module.get_submodule(owner_name)
        t = p.grad if grads and not batch_stats else p
        if t is None:
            raise ValueError(f"{name} has no gradient")
        arr = t.detach().float().cpu()
        if batch_stats:
            flax_leaf = leaf_of[leaf]
        elif leaf == "weight" and isinstance(owner, (nn.LayerNorm,
                                                     nn.modules.batchnorm._BatchNorm)):
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
    lecun-normal dense and conv kernels, zero biases, unit LN and BN scales,
    and rel_pos_bias tables truncated normal with std 0.02; BN running
    statistics at flax's start (mean 0, var 1)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            owner_name, _, leaf = name.rpartition(".")
            owner = module.get_submodule(owner_name)
            if leaf == "rel_pos_bias":
                _trunc_normal(p, 0.02, g)
            elif leaf == "bias":
                p.zero_()
            elif isinstance(owner, (nn.LayerNorm, nn.modules.batchnorm._BatchNorm)):
                p.fill_(1.0)
            else:
                # variance 1/fan_in after truncation at two std (flax's lecun_normal)
                _trunc_normal(p, (1.0 / p[0].numel()) ** 0.5 / 0.8796256610342398, g)
        for name, t in _stat_buffers(module).items():
            t.fill_(0.0 if name.endswith("running_mean") else 1.0)
