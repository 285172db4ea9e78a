"""Data samplers.

Counterpart of ``DistributedBatchSampler`` in
``deepspeed_tpu/runtime/data_pipeline/data_sampler.py``: deterministic
epoch-shuffled global batches (numpy's generator seeded with
``seed + epoch``, so both packages draw the same order), sliced per
data-parallel rank. ``CurriculumDataSampler`` comes with curriculum
learning in a later slice.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np


class DistributedBatchSampler:
    """Epoch-shuffled global batches, sliced per DP rank (reference
    data_sampler.py rank slicing; torch DistributedSampler semantics)."""

    def __init__(self, num_samples: int, global_batch_size: int,
                 rank: int = 0, world_size: int = 1, shuffle: bool = True,
                 seed: int = 42, drop_last: bool = True):
        if global_batch_size % world_size:
            raise ValueError(f"global batch {global_batch_size} not divisible "
                             f"by world size {world_size}")
        self.num_samples = int(num_samples)
        self.global_batch_size = int(global_batch_size)
        self.per_rank = self.global_batch_size // world_size
        self.rank = rank
        self.world_size = world_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)

    def __len__(self) -> int:
        if self.drop_last:
            return self.num_samples // self.global_batch_size
        return (self.num_samples + self.global_batch_size - 1) // self.global_batch_size

    def __iter__(self) -> Iterator[np.ndarray]:
        order = np.arange(self.num_samples)
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        n_full = self.num_samples // self.global_batch_size
        for b in range(len(self)):
            batch = order[b * self.global_batch_size:(b + 1) * self.global_batch_size]
            if b >= n_full:  # last partial batch (drop_last=False): wrap pad
                pad = self.global_batch_size - batch.size
                # tile when the corpus is smaller than the pad
                fill = np.tile(order, pad // order.size + 1)[:pad]
                batch = np.concatenate([batch, fill])
            yield batch[self.rank * self.per_rank:(self.rank + 1) * self.per_rank]
