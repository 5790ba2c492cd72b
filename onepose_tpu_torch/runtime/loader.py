"""Background prefetch of host batches, and their upload ahead of use.

The port's own copies of ``onepose_tpu/runtime/loader.py``'s
``PrefetchLoader`` (without its device upload: batches stay numpy, and
``PosePipeline`` moves each one to its device) and ``stage_ahead``, with
:class:`DeviceStager` as the staging function that puts a batch on a card
from pinned memory on a side stream (``serving.PoseServer.infer_many`` and
the train entry stage their batches so).
"""
from __future__ import annotations

import concurrent.futures as cf
import queue
import threading
from typing import Callable, Dict, Iterator, NamedTuple, Optional, Sequence

import numpy as np
import torch

from onepose_tpu_torch.utils.profiling import span


class PrefetchLoader:
    """Iterate batches of preprocessed frames with background prefetch.

    paths: image paths (or arbitrary work items); load_fn: item → numpy
    array; batch_size frames per batch; depth: prefetched batches; a short
    last batch is padded by repeating its last frame when ``pad_tail``.
    Yields (batch, items, number of real frames).
    """

    def __init__(self, paths: Sequence, load_fn: Callable,
                 batch_size: int = 8, depth: int = 2,
                 num_threads: int = 4, pad_tail: bool = True):
        self.paths = list(paths)
        self.load_fn = load_fn
        self.batch_size = batch_size
        self.depth = depth
        self.num_threads = num_threads
        self.pad_tail = pad_tail

    def __len__(self):
        return (len(self.paths) + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator:
        batch_queue: "queue.Queue" = queue.Queue(maxsize=self.depth)
        chunks = [
            self.paths[i:i + self.batch_size]
            for i in range(0, len(self.paths), self.batch_size)
        ]

        def producer():
            with cf.ThreadPoolExecutor(self.num_threads) as pool:
                for chunk in chunks:
                    arrays = list(pool.map(self.load_fn, chunk))
                    n_real = len(arrays)
                    if self.pad_tail:
                        while len(arrays) < self.batch_size:
                            arrays.append(arrays[-1])
                    batch_queue.put((np.stack(arrays), chunk, n_real))
            batch_queue.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = batch_queue.get()
            if item is None:
                break
            yield item


def stage_ahead(batches: Iterator, stage_fn: Callable,
                depth: int = 2) -> Iterator:
    """Apply ``stage_fn`` (typically a :class:`DeviceStager`) on a
    background thread ``depth`` batches ahead of consumption, so the
    upload of the next batches overlaps the device step: the loop costs
    max(upload, step) rather than their sum.

    Order-preserving; exceptions from ``stage_fn`` or the source iterator
    re-raise at the consumption point. The consumer's wait for a staged
    batch is the span ``loader.wait``.
    """
    out: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
    _end = object()
    stop = threading.Event()

    def producer():
        try:
            for b in batches:
                if stop.is_set():
                    return
                staged = stage_fn(b)
                # cooperative put: never block forever if the consumer
                # abandoned the generator (exception / GeneratorExit in
                # the caller's loop) — otherwise the thread and its
                # staged device batches leak for the process lifetime
                while not stop.is_set():
                    try:
                        out.put(staged, timeout=0.1)
                        break
                    except queue.Full:
                        continue
            if not stop.is_set():
                out.put(_end)
        except BaseException as e:  # re-raised by the consumer
            if not stop.is_set():
                out.put(e)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            with span("loader.wait"):
                item = out.get()
            if item is _end:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        while not out.empty():  # drop staged batches so device memory frees
            try:
                out.get_nowait()
            except queue.Empty:
                break
        t.join()


class Staged(NamedTuple):
    """A batch on its device and the event its copies recorded (None when
    nothing is pending)."""
    tensors: Dict[str, torch.Tensor]
    ready: Optional[torch.cuda.Event]

    def wait(self) -> Dict[str, torch.Tensor]:
        """The tensors, once the current stream (of the current device:
        the batch's) has waited for their copies; each tensor is marked as
        used on it."""
        if self.ready is not None:
            stream = torch.cuda.current_stream()
            stream.wait_event(self.ready)
            for t in self.tensors.values():
                t.record_stream(stream)
        return self.tensors


class DeviceStager:
    """A :func:`stage_ahead` staging function: a dict of numpy arrays →
    :class:`Staged` on ``device``. On a card the arrays are copied from
    pinned memory on a side stream, and an event is recorded after the
    copies; elsewhere they are plain tensors. A call is the span
    ``loader.stage``."""

    def __init__(self, device: torch.device | str):
        self.device = torch.device(device)
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)

    def __call__(self, batch: Dict[str, np.ndarray]) -> Staged:
        with span("loader.stage"):
            if self.stream is None:
                return Staged({k: torch.as_tensor(v, device=self.device)
                               for k, v in batch.items()}, None)
            with torch.cuda.device(self.device), \
                    torch.cuda.stream(self.stream):
                tensors = {k: torch.as_tensor(v).pin_memory().to(
                    self.device, non_blocking=True) for k, v in batch.items()}
                ready = torch.cuda.Event()
                ready.record(self.stream)
            return Staged(tensors, ready)
