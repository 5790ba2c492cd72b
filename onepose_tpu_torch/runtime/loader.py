"""Background prefetch of host batches for the port.

The port's own copy of ``onepose_tpu/runtime/loader.py::PrefetchLoader``,
without its device upload: batches stay numpy, and ``PosePipeline``
moves each one to its device.
"""
from __future__ import annotations

import concurrent.futures as cf
import queue
import threading
from typing import Callable, Iterator, Sequence

import numpy as np


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
