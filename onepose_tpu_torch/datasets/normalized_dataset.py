"""Inference image dataset: grayscale frames normalized to [0, 1].

The port's copy of ``onepose_tpu/datasets/normalized_dataset.py`` (the
reference's ``NormalizedDataset``): items are {path, image, size};
:meth:`NormalizedDataset.loader` batches them through the port's
``runtime.loader.PrefetchLoader``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


class NormalizedDataset:
    def __init__(self, img_lists: Sequence[str],
                 resize_hw: Optional[tuple] = None):
        self.img_lists = list(img_lists)
        self.resize_hw = resize_hw

    def __len__(self):
        return len(self.img_lists)

    def __getitem__(self, idx: int) -> dict:
        from onepose_tpu_torch.sfm.extract import load_gray

        path = self.img_lists[idx]
        image = load_gray(path, self.resize_hw)
        return {
            "path": path,
            "image": image,
            "size": np.array(image.shape[::-1]),  # (w, h)
        }

    def loader(self, batch_size: int = 8, depth: int = 2):
        """Batched prefetching iterator of [B, H, W, 1] arrays."""
        from onepose_tpu_torch.runtime.loader import PrefetchLoader
        from onepose_tpu_torch.sfm.extract import load_gray

        return PrefetchLoader(
            self.img_lists,
            lambda p: load_gray(p, self.resize_hw)[..., None],
            batch_size=batch_size, depth=depth)
