"""Training dataloader — the ``engine.deepspeed_io`` analogue.

Counterpart of ``deepspeed_tpu/runtime/data.py``: the engine consumes the
GLOBAL batch (``train_batch`` splits it into micro-batches), so the loader
yields whole global batches of numpy arrays, in the JAX package's order;
the engine moves them to its device.

Dataset forms accepted:
- ``dict[str, array]``        columns of equal leading dim N
- ``np.ndarray [N, S]``       token ids (wrapped as ``{"input_ids": ...}``)
- sequence of ``dict``        rows, stacked per key
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, Mapping, Sequence

import numpy as np

from .data_pipeline.data_sampler import DistributedBatchSampler


def _columns(dataset) -> dict[str, np.ndarray]:
    if isinstance(dataset, Mapping):
        cols = {k: np.asarray(v) for k, v in dataset.items()}
    elif isinstance(dataset, np.ndarray):
        cols = {"input_ids": dataset}
    elif isinstance(dataset, Sequence) and dataset and isinstance(dataset[0], Mapping):
        keys = set(dataset[0].keys())
        for i, row in enumerate(dataset):
            if set(row.keys()) != keys:
                raise ValueError(
                    f"row {i} keys {sorted(row.keys())} differ from row 0 "
                    f"keys {sorted(keys)}")
        cols = {k: np.stack([np.asarray(row[k]) for row in dataset])
                for k in keys}
    else:
        raise TypeError(
            f"unsupported dataset type {type(dataset).__name__}: want dict of "
            f"arrays, ndarray, or sequence of dict rows")
    sizes = {k: len(v) for k, v in cols.items()}
    if len(set(sizes.values())) != 1:
        raise ValueError(f"ragged dataset columns: {sizes}")
    return cols


class DataLoader:
    """Global-batch loader with epoch shuffling (reference
    DeepSpeedDataLoader + DistributedSampler roles)."""

    def __init__(self, dataset, batch_size: int, *, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True,
                 collate_fn: Callable[[dict], Any] | None = None):
        self.cols = _columns(dataset)
        self.n = next(iter(self.cols.values())).shape[0]
        if batch_size <= 0:
            raise ValueError("batch_size must be positive")
        if drop_last and self.n < batch_size:
            raise ValueError(f"dataset of {self.n} rows smaller than one "
                             f"global batch ({batch_size})")
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.sampler = DistributedBatchSampler(
            self.n, batch_size, shuffle=shuffle, seed=seed,
            drop_last=drop_last)

    def set_epoch(self, epoch: int) -> None:
        self.sampler.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.sampler)

    def __iter__(self) -> Iterator[dict]:
        for idx in self.sampler:
            batch = {k: v[idx] for k, v in self.cols.items()}
            yield self.collate_fn(batch) if self.collate_fn else batch

    def batch_for_step(self, step: int) -> dict:
        """Deterministic random access: the batch this loader yields at
        global step ``step`` (0-based, counting from the start of training)
        under per-epoch reshuffling.

        This is the data-order half of resuming a run: with
        ``engine.global_steps`` restored by ``load_checkpoint`` or by the
        sentinel's rewind (``engine.last_step_rewound``),
        ``loader.batch_for_step(engine.global_steps)`` replays the stream
        the lost run saw. Every rank gets the same global batch, which
        ``train_batch`` splits by rank.

        Note: mutates the sampler's epoch to ``step // len(self)`` — mixing
        with a concurrent ``__iter__`` of a different epoch is undefined.
        """
        per_epoch = len(self.sampler)
        if per_epoch == 0:
            raise ValueError("empty loader (fewer rows than one batch)")
        epoch, offset = divmod(int(step), per_epoch)
        self.sampler.set_epoch(epoch)
        for i, idx in enumerate(self.sampler):
            if i == offset:
                batch = {k: v[idx] for k, v in self.cols.items()}
                return self.collate_fn(batch) if self.collate_fn else batch
        raise AssertionError("unreachable: offset < len(sampler)")
