"""Host-side input pipeline: threaded decode into batches, and a prefetch that
copies each batch to the device while the previous one is being used.

The port's copy of ``dffx/data/pipeline.py``.  ``Loader`` is the same, with
``dffx``'s process sharding: under data-parallel training (one process a
rank, ``dffx_torch.parallel``) every rank shuffles with the same seed and
decodes only its contiguous ``batch_size / process_count`` rows of each
global batch.  ``device_prefetch``
replaces ``jax.device_put`` with the copy the reference's
``DataLoader(pin_memory=True)`` makes possible (`train_code_DDFF.py:69-70`):
a producer thread pins each batch and copies it with ``non_blocking=True`` on a
side CUDA stream, so that the copy of batch k+1 overlaps the work on batch k.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, Iterator, Sequence, Tuple

import numpy as np
import torch


def _stack_batch(samples: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    # "unpadded" (h, w) tuples stack to a (B, 2) int array — batched eval
    # needs them; the train CLI filters its batch keys anyway
    return {k: np.stack([np.asarray(s[k]) for s in samples], axis=0) for k in samples[0]}


class Loader:
    """Minimal epoch-based batched loader with threaded sample decoding."""

    def __init__(
        self,
        dataset,
        batch_size: int = 1,
        *,
        shuffle: bool = False,
        drop_last: bool = False,
        num_threads: int = 4,
        seed: int = 0,
        lookahead: int = 4,
        process_id: int = 0,
        process_count: int = 1,
    ):
        """``batch_size`` is the GLOBAL batch.  Under multi-process data
        parallelism each process constructs the identical shuffled order (same
        seed) and loads only its contiguous ``batch_size / process_count``
        slice of every batch — sample-index sharding, no cross-process IO."""
        if process_count > 1:
            assert batch_size % process_count == 0, (batch_size, process_count)
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_threads = num_threads
        self.lookahead = lookahead
        self.process_id = process_id
        self.process_count = process_count
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(order)
        batches = [
            order[i : i + self.batch_size]
            for i in range(0, len(order), self.batch_size)
        ]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        if self.process_count > 1:
            # every batch must be full so that the processes' slices line up
            # (partial trailing batches dropped)
            local = self.batch_size // self.process_count
            batches = [
                b[self.process_id * local : (self.process_id + 1) * local]
                for b in batches
                if len(b) == self.batch_size
            ]

        with ThreadPoolExecutor(max_workers=self.num_threads) as pool:
            futs = queue.Queue()
            it = iter(batches)

            def submit_next():
                try:
                    idxs = next(it)
                except StopIteration:
                    return False
                futs.put(pool.submit(self._load_batch, idxs))
                return True

            for _ in range(self.lookahead):
                if not submit_next():
                    break
            while not futs.empty():
                fut = futs.get()
                submit_next()
                yield fut.result()

    def _load_batch(self, idxs) -> Dict[str, np.ndarray]:
        return _stack_batch([self.dataset[int(i)] for i in idxs])


def device_prefetch(
    iterator: Iterable[Dict[str, np.ndarray]],
    device,
    keys: Sequence[str],
    *,
    size: int = 2,
) -> Iterator[Tuple[Dict[str, np.ndarray], Dict[str, torch.Tensor]]]:
    """Yield ``(batch, on_device)``: each host batch of ``iterator`` beside the
    tensors of those of ``keys`` it holds on ``device``, copied up to ``size``
    batches ahead of the consumer.

    On a CUDA device a producer thread pins each array (``pin_memory``) and
    copies it with ``non_blocking=True`` on a side stream, then records an
    event there.  Before the consumer gets the batch, its current stream waits
    for that event (that batch's copies, not later ones), and each tensor is
    marked used on the consumer's stream (``record_stream``), so that the
    allocator does not hand its memory to the copy stream while the
    consumer's work still reads it.  On the CPU the arrays become tensors
    (``torch.as_tensor``, no copy).  A failure to pin or copy raises to the
    consumer; there is no pageable or synchronous fallback."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    copy_stream = torch.cuda.Stream(device) if cuda else None
    buf: "queue.Queue" = queue.Queue(maxsize=size)
    sentinel = object()
    error: list = []
    stop = threading.Event()  # set when the consumer abandons the generator

    def put(batch):
        chosen = [k for k in keys if k in batch]
        if not cuda:
            return batch, {k: torch.as_tensor(batch[k]) for k in chosen}, None
        with torch.cuda.stream(copy_stream):
            on_device = {k: torch.from_numpy(np.ascontiguousarray(batch[k])).pin_memory()
                         .to(device, non_blocking=True) for k in chosen}
            done = torch.cuda.Event()
            done.record(copy_stream)
        return batch, on_device, done

    def put_or_stop(item) -> bool:
        # a plain buf.put would block forever if the consumer broke out of
        # the generator early (e.g. --steps-per-epoch), pinning this thread
        # AND the Loader's ThreadPoolExecutor for the process lifetime
        while not stop.is_set():
            try:
                buf.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for batch in iterator:
                if not put_or_stop(put(batch)):
                    return
        except BaseException as e:  # surface decode/transfer errors, don't
            error.append(e)         # silently truncate the epoch
        finally:
            put_or_stop(sentinel)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = buf.get()
            if item is sentinel:
                break
            batch, on_device, done = item
            if cuda:
                current = torch.cuda.current_stream(device)
                current.wait_event(done)
                for tensor in on_device.values():
                    tensor.record_stream(current)
            yield batch, on_device
    finally:
        stop.set()  # releases the producer (and the Loader's pool) on early exit
    if error:
        raise error[0]
