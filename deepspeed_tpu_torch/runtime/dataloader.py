"""Data loading (counterpart of ``deepspeed_tpu/runtime/dataloader.py``).

``DeepSpeedDataLoader`` yields batches of ``batch_size`` rows (the engine's
``deepspeed_io`` asks for the global micro batch, ``micro x dp`` rows, as
the JAX engine does: every rank reads the same batch and keeps its own
rows) as dicts of numpy arrays, which the engine moves to its device; ``RepeatingLoader`` restarts the wrapped
loader at exhaustion. With ``drop_last=False`` a ragged tail batch is padded
and gets an ``attention_mask``, which sends the model off the flash path.
"""

import math
from typing import Any, Callable, Iterable, Iterator, Optional

import numpy as np


def default_collate(samples):
    """Stack a list of dict/array samples into one batch."""
    first = samples[0]
    if isinstance(first, dict):
        return {k: np.stack([s[k] for s in samples]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(np.stack(cols) for cols in zip(*samples))
    return np.stack(samples)


def _pad_to_batch_size(batch, batch_size: int):
    """Pad a (possibly ragged tail) batch to ``batch_size`` rows.

    Dict batches get zero rows plus an ``attention_mask`` that zeroes the
    pad rows out of attention AND the loss (the model's weighting path);
    the mask is emitted for full batches too so that every batch has the
    same keys.
    Non-dict batches just get zero rows (no mask channel to thread)."""
    if isinstance(batch, dict):
        n = next(iter(batch.values())).shape[0]
        pad = batch_size - n
        out = {}
        for k, v in batch.items():
            if pad:
                zeros = np.zeros((pad,) + v.shape[1:], v.dtype)
                out[k] = np.concatenate([v, zeros], axis=0)
            else:
                out[k] = v
        if "attention_mask" not in out and "input_ids" in out:
            mask = np.zeros(out["input_ids"].shape[:2], np.int32)
            mask[:n] = 1
            out["attention_mask"] = mask
        return out
    if isinstance(batch, (tuple, list)):
        return type(batch)(_pad_to_batch_size(v, batch_size) for v in batch)
    pad = batch_size - batch.shape[0]
    if not pad:
        return batch
    zeros = np.zeros((pad,) + batch.shape[1:], batch.dtype)
    return np.concatenate([batch, zeros], axis=0)


class DeepSpeedDataLoader:
    """Iterates a map-style dataset in batches of ``batch_size`` rows."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        drop_last: bool = True,
        collate_fn: Optional[Callable] = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self._base_seed = seed
        self.drop_last = drop_last
        self.collate_fn = collate_fn or default_collate
        # drop_last=False with a ragged tail: the tail is PADDED to the
        # full batch and masked via attention_mask, which then exists on
        # every batch so that every step sees the same batch structure
        self._pad_tail = (not drop_last) and (len(dataset) % batch_size != 0)
        self.epoch = 0
        # bumped whenever (seed, epoch) changes out-of-band (reseed or
        # load_state_dict): RepeatingLoader watches it to restart its
        # iterator so the new order takes effect mid-epoch
        self.order_version = 0
        if drop_last:
            self.num_batches = len(dataset) // batch_size
        else:
            self.num_batches = math.ceil(len(dataset) / batch_size)
        if self.num_batches == 0:
            raise ValueError(
                f"dataset of {len(dataset)} samples yields zero batches of "
                f"global size {batch_size}"
            )

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def reseed(self, offset: int):
        """Derive a fresh shuffle order (seed = base seed + offset)."""
        self.seed = self._base_seed + int(offset)
        self.order_version += 1

    def state_dict(self):
        """The data-order state (epoch, seed)."""
        return {"epoch": self.epoch, "seed": self.seed}

    def load_state_dict(self, state):
        self.epoch = int(state.get("epoch", self.epoch))
        self.seed = int(state.get("seed", self.seed))
        self.order_version += 1

    def __len__(self):
        return self.num_batches

    def __iter__(self) -> Iterator[Any]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            rng.shuffle(order)
        for b in range(self.num_batches):
            idx = order[b * self.batch_size:(b + 1) * self.batch_size]
            samples = [self.dataset[int(i)] for i in idx]
            batch = self.collate_fn(samples)
            if self._pad_tail:
                batch = _pad_to_batch_size(batch, self.batch_size)
            yield batch


class RepeatingLoader:
    """Restart the wrapped loader at exhaustion."""

    def __init__(self, loader: Iterable):
        self.loader = loader
        self.data_iter = iter(self.loader)
        self._order_version = getattr(loader, "order_version", None)

    def __iter__(self):
        return self

    def __next__(self):
        inner_version = getattr(self.loader, "order_version", None)
        if inner_version != self._order_version:
            # the wrapped loader was reseeded/restored out-of-band: the
            # in-flight iterator still walks the OLD order — restart it
            self._order_version = inner_version
            self.data_iter = iter(self.loader)
        try:
            return next(self.data_iter)
        except StopIteration:
            if hasattr(self.loader, "set_epoch"):
                self.loader.set_epoch(getattr(self.loader, "epoch", 0) + 1)
            self.data_iter = iter(self.loader)
            return next(self.data_iter)

    def state_dict(self):
        if hasattr(self.loader, "state_dict"):
            return self.loader.state_dict()
        return {}

    def load_state_dict(self, state):
        if hasattr(self.loader, "load_state_dict"):
            self.loader.load_state_dict(state)
