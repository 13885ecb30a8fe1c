"""Batch loader over pair datasets, sharded across processes.

The port's copy of the numpy data layer's batcher
(`featurematching_tpu/data/loader.py`: `train_val_split`, `ConcatDataset`,
`scene_balanced_indices`, `_stack`, `BatchLoader`): scene-balanced
sampling with replacement, a deterministic 85/15 train/val split, and
per-process sharding keyed by the caller's `process_index` and
`process_count` (0 and 1 by default; the JAX package asks
`jax.process_index()`). Indices are drawn host-side with numpy, samples are
loaded in a small thread pool and stacked into the fixed-shape batch. The
native-cache factory `make_loader` is not ported yet.
"""

from __future__ import annotations

import concurrent.futures as cf
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np


def train_val_split(items: Sequence, val_fraction: float = 0.15, seed: int = 0):
    """Deterministic 85/15 split."""
    items = list(items)
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(items))
    n_val = max(1, int(round(len(items) * val_fraction))) if len(items) > 1 else 0
    val_idx = set(order[:n_val].tolist())
    train = [x for i, x in enumerate(items) if i not in val_idx]
    val = [x for i, x in enumerate(items) if i in val_idx]
    return train, val


class ConcatDataset:
    """Minimal concat over map-style datasets."""

    def __init__(self, datasets: Sequence):
        self.datasets = list(datasets)
        self.offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self) -> int:
        return int(self.offsets[-1])

    def __getitem__(self, idx: int):
        d = int(np.searchsorted(self.offsets, idx, side="right") - 1)
        return self.datasets[d][idx - int(self.offsets[d])]


def scene_balanced_indices(
    dataset_sizes: Sequence[int],
    n_samples_per_subset: int,
    replacement: bool = True,
    shuffle: bool = True,
    repeat: int = 1,
    seed: int = 0,
) -> np.ndarray:
    """Fixed-count per-scene sampling."""
    rng = np.random.default_rng(seed)
    chunks = []
    offset = 0
    for size in dataset_sizes:
        if size == 0:
            continue
        if replacement or n_samples_per_subset > size:
            pick = rng.integers(0, size, n_samples_per_subset)
        else:
            pick = rng.permutation(size)[:n_samples_per_subset]
        chunks.append(pick + offset)
        offset += size
    idx = np.concatenate(chunks) if chunks else np.zeros((0,), np.int64)
    if shuffle:
        idx = rng.permutation(idx)
    if repeat > 1:
        idx = np.concatenate([idx] * repeat)
    return idx


def _stack(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    keys = samples[0].keys()
    return {k: np.stack([s[k] for s in samples]) for k in keys}


class BatchLoader:
    """Iterates fixed-shape batches; shards batches across hosts.

    Per epoch: the global index order is derived from (seed, epoch)
    identically in every process; each process takes its
    process_index-strided slice.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        num_threads: int = 8,
        process_index: int = 0,
        process_count: int = 1,
        indices: Optional[np.ndarray] = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_threads = num_threads
        self._indices_override = indices
        self.process_index = process_index
        self.process_count = process_count or 1

    def epoch_indices(self, epoch: int) -> np.ndarray:
        if self._indices_override is not None:
            idx = np.asarray(self._indices_override)
        else:
            idx = np.arange(len(self.dataset))
            if self.shuffle:
                rng = np.random.default_rng((self.seed, epoch))
                idx = rng.permutation(idx)
        # host shard: strided slice
        return idx[self.process_index :: self.process_count]

    def __len__(self) -> int:
        n = len(self.epoch_indices(0))
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def epoch(self, epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        idx = self.epoch_indices(epoch)
        nb = len(idx) // self.batch_size if self.drop_last else -(
            -len(idx) // self.batch_size
        )
        with cf.ThreadPoolExecutor(self.num_threads) as pool:
            for b in range(nb):
                sel = idx[b * self.batch_size : (b + 1) * self.batch_size]
                samples = list(pool.map(self.dataset.__getitem__, sel))
                while len(samples) < self.batch_size:  # pad final partial batch
                    samples.append(samples[-1])
                yield _stack(samples)
