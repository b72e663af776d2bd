"""Batch loader with background prefetch onto the device (counterpart of
vivqa_tpu/data/loader.py).

``BatchLoader`` is a copy of the JAX package's: a shuffling, fixed-batch
iterator over a map-style dataset, in the same ``RandomState(seed +
epoch)`` order. ``device_prefetch`` replaces its ``jax.device_put``
prefetcher: a host thread assembles the batches; on the card each numpy
array is staged in pinned memory and copied with ``non_blocking=True`` on
a side stream, so the copy of batch n+1 overlaps the step on batch n.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

import numpy as np
import torch


class BatchLoader:
    """Shuffling, fixed-batch-size iterator over a map-style dataset.
    drop_last=True keeps shapes static across steps."""

    def __init__(self, dataset, batch_size: int, collate: Callable,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = True,
                 pad_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate = collate
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        # pad_last: pad a trailing partial batch to full batch_size by
        # repeating the last item (every batch has one shape); the batch's
        # `_num_valid` records the real count so metric code can trim
        self.pad_last = pad_last
        self.epoch = 0

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else \
            (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[dict]:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        self.epoch += 1
        end = n - n % self.batch_size if self.drop_last else n
        load_batch = getattr(self.dataset, "load_batch", None)
        # the native path builds the batch with the DATASET's collate;
        # honor a custom collate by assembling item by item
        if load_batch is not None and \
                self.collate is not getattr(self.dataset,
                                            "default_collate", None):
            load_batch = None
        for start in range(0, end, self.batch_size):
            chunk = list(idx[start:start + self.batch_size])
            num_valid = len(chunk)
            if num_valid < self.batch_size and self.pad_last:
                chunk = chunk + [chunk[-1]] * (self.batch_size - num_valid)
            # native C++ path (decode + augment + normalize in one call);
            # None -> per-item PIL path
            batch = load_batch(chunk) if load_batch is not None else None
            if batch is None:
                batch = self.collate([self.dataset[int(i)] for i in chunk])
            batch["_num_valid"] = num_valid
            yield batch


def host_tensor(v: np.ndarray) -> torch.Tensor:
    """A numpy array as a CPU tensor: signed integers (ids, masks, labels)
    as int64, as the embeddings and the loss take them; floats and uint8
    pixels as they are."""
    t = torch.from_numpy(np.ascontiguousarray(v))
    return t.long() if v.dtype.kind == "i" else t


def device_prefetch(iterator: Iterator[dict], device: str | torch.device,
                    buffer_size: int = 2) -> Iterator[dict]:
    """Yield the batches of ``iterator`` (dicts) with their numpy arrays as
    tensors on ``device``; other values (strings, answer-count dicts,
    ``_num_valid``) ride along on the host.

    A host thread runs ``iterator`` up to ``buffer_size`` batches ahead.
    On a card it copies each array through a fresh pinned buffer with
    ``non_blocking=True`` on its own stream and records an event; the
    consumer's stream waits for that event before the batch is yielded,
    and each tensor is marked as used by the consumer's stream
    (``record_stream``), so the allocator does not hand its memory to a
    later batch's copy while a step still reads it. On the CPU the arrays
    are wrapped as they are. An exception in the thread is raised to the
    consumer; a consumer that stops early stops the thread."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    copy_stream = torch.cuda.Stream(device=device) if cuda else None
    q: queue.Queue = queue.Queue(maxsize=buffer_size)
    stop = threading.Event()
    end = object()

    def place(batch: dict):
        host = {k: host_tensor(v) for k, v in batch.items()
                if isinstance(v, np.ndarray)}
        rest = {k: v for k, v in batch.items() if k not in host}
        if not cuda:
            return {**host, **rest}, None
        with torch.cuda.stream(copy_stream):
            dev = {k: t.pin_memory().to(device, non_blocking=True)
                   for k, t in host.items()}
            done = torch.cuda.Event()
            done.record(copy_stream)
        return {**dev, **rest}, done

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for batch in iterator:
                if not put(place(batch)):
                    return
            put(end)
        except BaseException as e:   # handed to the consumer, never lost
            put(e)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is end:
                break
            if isinstance(item, BaseException):
                raise item
            batch, done = item
            if done is not None:
                stream = torch.cuda.current_stream(device)
                stream.wait_event(done)
                for v in batch.values():
                    if isinstance(v, torch.Tensor):
                        v.record_stream(stream)
            yield batch
    finally:
        stop.set()
        thread.join()
