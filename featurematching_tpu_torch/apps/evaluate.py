"""Dataset evaluation CLI: matching and pose metrics over a pair dataset.

Port of `featurematching_tpu/apps/evaluate.py`. Usage:

    python -m featurematching_tpu_torch.apps.evaluate synthetic [--limit N]
        [--batch 4] [--gray] [--size W H] [--thr 0.2] [--device cuda]
        [--out metrics.json]

Prints the aggregate metric dict (pose AUC@5/10/20, precision@5e-4) as JSON.
On the card (the default) the default_config() swin_v1 matcher runs the
serving forward (`FastMatcher`, K1–K6); with `--device cpu` it runs the
`Matcher` in float32. Each batch's epipolar errors, RANSAC poses and pose
errors stay on the device until the loop ends; only the aggregation reads
them back.

Not ported yet, and raising NotImplementedError: the scared, endoslam and
unity readers and `--ckpt` (orbax checkpoints; ROADMAP queue A item 5), and
`--model-shard > 1` (the sharded correlation; queue A item 6).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Optional

import numpy as np
import torch

from featurematching_tpu_torch.config import default_config
from featurematching_tpu_torch.data.loader import BatchLoader
from featurematching_tpu_torch.data.synthetic import synthetic_batch
from featurematching_tpu_torch.geometry.ransac import gumbel_noise
from featurematching_tpu_torch.utils.metrics import (
    aggregate_metrics,
    compute_symmetrical_epipolar_errors,
    pose_errors_from_noise,
)


def build_matcher(gray: bool = False, thr: float = 0.2, device="cuda"):
    """default_config()'s matcher with the input channels and coarse threshold
    given, seeded weights (seed 0): on the card the serving forward
    (`FastMatcher`) for a swin_v1 backbone, on the CPU the `Matcher` in
    float32, as the JAX app picks its forward by backend."""
    from featurematching_tpu_torch.models.fast_inference import FastMatcher
    from featurematching_tpu_torch.models.matcher import Matcher

    dev = torch.device(device)
    cfg = default_config().model
    mcfg = dataclasses.replace(
        cfg,
        input_channels=1 if gray else 3,
        match_coarse=dataclasses.replace(cfg.match_coarse, thr=thr),
    )
    if dev.type == "cpu":
        mcfg = dataclasses.replace(mcfg, compute_dtype="float32")
    if mcfg.backbone_type == "swin_v1" and dev.type != "cpu":
        return FastMatcher(mcfg, device=dev, seed=0)
    return Matcher(mcfg, device=dev, seed=0)


def batch_errors(mkpts0, mkpts1, mask, T_0to1, K0, K1, gumbel, pixel_thr: float = 0.5):
    """One batch's metric chain on the device: the symmetric epipolar errors
    [B, K] (inf on padding) and the RANSAC pose errors (a dict of [B]
    tensors, `utils.metrics.compute_pose_errors`), given the hypotheses'
    Gumbel noise [B, H, K]."""
    epi = compute_symmetrical_epipolar_errors(mkpts0, mkpts1, mask, T_0to1, K0, K1)
    pose = pose_errors_from_noise(mkpts0, mkpts1, mask, T_0to1, K0, K1, gumbel, pixel_thr)
    return epi, pose


def evaluate_dataset(
    dataset,
    ckpt: Optional[str] = None,
    batch_size: int = 4,
    limit: Optional[int] = None,
    gray: bool = False,
    thr: float = 0.2,
    num_hypotheses: int = 512,
    model_shard: int = 1,
    device="cuda",
):
    """Matches each batch of `dataset`, runs the metric chain on the device
    (one generator seeded with 0 draws every batch's RANSAC noise) and
    aggregates on the host."""
    if ckpt:
        raise NotImplementedError(
            "--ckpt: the port does not read the JAX package's orbax checkpoints yet "
            "(ROADMAP queue A item 5); evaluate with seeded weights")
    if model_shard > 1:
        raise NotImplementedError(
            "--model-shard > 1: the sharded coarse correlation is not ported yet "
            "(ROADMAP queue A item 6)")
    dev = torch.device(device)
    model = build_matcher(gray, thr, dev)
    loader = BatchLoader(dataset, batch_size, shuffle=False, drop_last=False)
    gen = torch.Generator(device=dev).manual_seed(0)
    results = []  # per batch, on the device until the loop ends
    n_done = 0
    with torch.no_grad():
        for batch in loader.epoch(0):
            tb = {k: torch.from_numpy(batch[k]).to(dev)
                  for k in ("image0", "image1", "T_0to1", "K0", "K1")}
            out = model(tb["image0"], tb["image1"])
            mask = out.coarse.mask
            g = gumbel_noise(gen, (mask.shape[0], num_hypotheses, mask.shape[1]))
            epi, pose = batch_errors(out.fine.mkpts0_f, out.fine.mkpts1_f, mask,
                                     tb["T_0to1"], tb["K0"], tb["K1"], g)
            results.append((batch["pair_id"], epi, mask, pose["R_errs"], pose["t_errs"]))
            n_done += mask.shape[0]
            if limit and n_done >= limit:
                break

    agg = {"identifiers": [], "R_errs": [], "t_errs": [], "epi_errs": []}
    for ids, epi, mask, R_errs, t_errs in results:
        epi_np, mask_np = epi.cpu().numpy(), mask.cpu().numpy()
        for b in range(epi_np.shape[0]):
            agg["identifiers"].append(int(ids[b]))
            agg["epi_errs"].append(epi_np[b][mask_np[b]])
        agg["R_errs"].extend(R_errs.cpu().numpy().tolist())
        agg["t_errs"].extend(t_errs.cpu().numpy().tolist())
    return aggregate_metrics(agg)


class SyntheticPairs:
    """n synthetic pairs of W x H (`data.synthetic.synthetic_batch`, rng seed
    0), one a sample with its `pair_id`; n_planes=2 the two-plane scene."""

    def __init__(self, n: int, W: int, H: int, gray: bool, n_planes: int = 1):
        batch = synthetic_batch(np.random.default_rng(0), batch_size=n, image_size=(H, W),
                                channels=1 if gray else 3, n_planes=n_planes)
        self.samples = [{k: v[i] for k, v in batch.items()} | {"pair_id": np.int32(i)}
                        for i in range(n)]

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]


def build_dataset(kind: str, root: Optional[str], args) -> object:
    size = tuple(args.size)
    if kind in ("scared", "endoslam", "unity"):
        raise NotImplementedError(
            f"the {kind} reader is not ported yet (ROADMAP queue A item 5); the port "
            f"evaluates the synthetic dataset")
    if kind == "synthetic":
        return SyntheticPairs(args.limit or 8, size[0], size[1], args.gray)
    raise ValueError(kind)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("dataset", choices=["scared", "endoslam", "unity", "synthetic"])
    p.add_argument("root", nargs="?", default=None)
    p.add_argument("--ckpt", default=None)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--gray", action="store_true")
    p.add_argument("--size", type=int, nargs=2, default=(640, 480))
    p.add_argument("--thr", type=float, default=0.2)
    p.add_argument("--model-shard", type=int, default=1,
                   help="shard the coarse correlation over N devices (not ported yet)")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    ds = build_dataset(args.dataset, args.root, args)
    results = evaluate_dataset(
        ds, ckpt=args.ckpt, batch_size=args.batch, limit=args.limit,
        gray=args.gray, thr=args.thr,
        model_shard=args.model_shard, device=args.device,
    )
    text = json.dumps(results, indent=2)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
