"""The frozen teacher: a Matcher that labels image pairs with deep matches.

Port of `featurematching_tpu/data/teacher.py` (make_teacher_fn,
save_teacher_ckpt, load_teacher_ckpt, `_pad_to_multiple`). The teacher is a
`models.matcher.Matcher` in evaluation: by default the coarse-only LoFTR-tiny
profile (`config.loftr_tiny_config()`: ResNet-FPN, the sine encoding, the
8-layer coarse transformer, dual-softmax matching, float32), whose forward
on the card runs K9's forward on K5's float32 kernels (12 calls) and K1's
float32 kernel (once), and the backbone's convolutions on cuDNN without
TF32 and with timed algorithms (`models/backbone_resnet_fpn.ResNetFPN`,
whatever the caller's `torch.backends.cudnn` settings). A native checkpoint (`.npz`, the JAX
package's format) carries its own model config and runs as it was trained:
coarse-only or with its fine stage.

The checkpoint functions use numpy alone, so a file either package writes
loads in the other: `p:<flax path>` for each parameter, `s:<flax path>` for
each BatchNorm statistic, and `cfg_json`, the model config as JSON bytes.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from featurematching_tpu_torch.config import ModelConfig, config_from_dict, loftr_tiny_config
from featurematching_tpu_torch.models.matcher import Matcher
from featurematching_tpu_torch.utils.weights import flatten_tree, load_jax_params

MatchFn = Callable[[np.ndarray, np.ndarray], Tuple[np.ndarray, np.ndarray]]


def _pad_to_multiple(img: np.ndarray, mult: int) -> np.ndarray:
    """Zero-pad H and W of an [H, W] image up to the next multiple of `mult`."""
    h, w = img.shape
    ph, pw = (-h) % mult, (-w) % mult
    if ph or pw:
        img = np.pad(img, ((0, ph), (0, pw)))
    return img


def make_teacher_fn(ckpt: Optional[str] = None, cfg=None, thr: Optional[float] = None,
                    device="cuda", seed: int = 0) -> MatchFn:
    """A frozen-teacher match function.

    Args:
      ckpt: a native teacher checkpoint (`.npz`, `save_teacher_ckpt`'s
        format from either package): its config and weights, coarse-only or
        not as saved. Without one the teacher is `cfg`'s model, forced
        coarse-only, with the port's seeded init (`seed`): random weights,
        for plumbing and timing only. That init cannot reproduce the JAX
        package's (flax's `PRNGKey(0)`). The official LoFTR checkpoint
        (a `.ckpt`) is not read yet: it raises.
      cfg: a full `config.Config`; `loftr_tiny_config()` by default.
      thr: the coarse confidence threshold in place of the config's.
      device: 'cuda' (the card, by default) or 'cpu' (the plain twins).

    Returns fn(img0, img1) -> (kp0 [M, 2], kp1 [M, 2]): full-resolution
    (x, y) float32 keypoints of the matches, for [H, W] grayscale images,
    uint8 or float in [0, 1]. The images are zero-padded to a multiple of
    the coarse stride, and matches that land in the pad are dropped.
    """
    if ckpt and ckpt.endswith(".npz"):
        model_cfg, params, stats = load_teacher_ckpt(ckpt)
    elif ckpt:
        raise NotImplementedError(
            f"{ckpt}: the official LoFTR checkpoint loader is not ported; a teacher reads "
            f"native .npz checkpoints (save_teacher_ckpt)")
    else:
        params = stats = None
        model_cfg = dataclasses.replace((cfg or loftr_tiny_config()).model, coarse_only=True)
    if thr is not None:
        model_cfg = dataclasses.replace(
            model_cfg, match_coarse=dataclasses.replace(model_cfg.match_coarse, thr=thr))
    model = Matcher(model_cfg, device=device, seed=seed)
    if params is not None:
        load_jax_params(model, params, stats)
    sc = model_cfg.resolution[0]

    @torch.no_grad()
    def match(img0: np.ndarray, img1: np.ndarray):
        h, w = img0.shape
        a0 = _pad_to_multiple(np.asarray(img0), sc).astype(np.float32)
        a1 = _pad_to_multiple(np.asarray(img1), sc).astype(np.float32)
        if a0.max() > 1.5:  # uint8 range
            a0, a1 = a0 / 255.0, a1 / 255.0
        dev = model.device
        b0 = torch.as_tensor(a0, device=dev)[None, :, :, None]
        b1 = torch.as_tensor(a1, device=dev)[None, :, :, None]
        out = model(b0, b1, train=False)
        c = out.coarse
        if model_cfg.coarse_only:
            k0, k1 = c.mkpts0_c, c.mkpts1_c
        else:  # the fine keypoints (x, y, std): the std dropped
            k0, k1 = out.fine.mkpts0_f[..., :2], out.fine.mkpts1_f[..., :2]
        k0 = k0[0].float().cpu().numpy()
        k1 = k1[0].float().cpu().numpy()
        m = c.mask[0].cpu().numpy().copy()
        m &= (k0[:, 0] < w) & (k0[:, 1] < h) & (k1[:, 0] < w) & (k1[:, 1] < h)
        return k0[m], k1[m]

    return match


def _nest(flat: Dict[str, np.ndarray]) -> Dict:
    tree: Dict = {}
    for path, v in flat.items():
        *mods, leaf = path.split("/")
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = v
    return tree


def save_teacher_ckpt(path: str, model_cfg: ModelConfig, params: Dict,
                      batch_stats: Optional[Dict]) -> None:
    """Write a teacher checkpoint (.npz): flax-style `params` and
    `batch_stats` trees of arrays (`utils/weights.to_jax_tree`) and the
    model config."""
    arrs = {"p:" + k: v for k, v in flatten_tree(params).items()}
    arrs.update({"s:" + k: v for k, v in flatten_tree(batch_stats or {}).items()})
    arrs["cfg_json"] = np.frombuffer(
        json.dumps(dataclasses.asdict(model_cfg)).encode(), np.uint8)
    np.savez_compressed(path, **arrs)


def load_teacher_ckpt(path: str):
    """Read a teacher checkpoint -> (ModelConfig, params, batch_stats), the
    trees as nested dicts of numpy arrays."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    cfg = config_from_dict(ModelConfig, json.loads(bytes(flat.pop("cfg_json")).decode()))
    params = _nest({k[2:]: v for k, v in flat.items() if k.startswith("p:")})
    stats = _nest({k[2:]: v for k, v in flat.items() if k.startswith("s:")})
    return cfg, params, stats
