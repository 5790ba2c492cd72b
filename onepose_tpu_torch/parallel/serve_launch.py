"""Pose serving over a world of processes.

Counterpart of ``onepose_tpu/parallel/serve_launch.py``. One process per
card forms a world (``launch.run_local`` on one host,
``launch.maybe_initialize`` across hosts); the catalog is sharded over
the mesh's model axis and every request batch is one collective serve
step in which all ranks take part (``serving.PoseServer(mesh=...)``).

- **Rank 0 owns the frontend.** It takes requests, pads them to the
  static batch and broadcasts the host batch to every rank. The payload
  has fixed shapes: a header (stop, number of real requests), images
  [B, H, W], intrinsics [B, 3, 3] and object indices [B].
- **A frontend error on rank 0** (an unknown object name, a wrong image
  shape, a raising ``next_batch``) still reaches the broadcast: the other
  ranks are waiting in it, so rank 0 broadcasts stop and then re-raises.
- **Outputs are replicated**: every rank gets every result; rank 0 alone
  delivers them. RANSAC's noise comes from the generator that every rank
  seeds with the same ``seed``, drawn for the whole batch and split by
  rows, so a world of any size reproduces a server of one process on the
  same request sequence.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from onepose_tpu_torch import serving
from onepose_tpu_torch.parallel import collectives as comm
from onepose_tpu_torch.runtime import loader
from onepose_tpu_torch.serving import PoseRequest


class MultiHostPoseServer(serving.PoseServer):
    """``serving.PoseServer`` over a mesh of several processes. ``mesh``
    is required; construction is collective (every rank builds the server
    with the same catalog and seed)."""

    def __init__(self, *args, **kwargs):
        if kwargs.get("mesh") is None:
            raise ValueError("MultiHostPoseServer requires mesh=")
        super().__init__(*args, **kwargs)

    def encode_batch(self, requests: Sequence[PoseRequest]):
        """A request list padded to the static batch, as host arrays:
        images [B, H, W], Ks [B, 3, 3], obj_idx [B] and the number of real
        requests (the broadcast payload; rank 0 only)."""
        images, Ks, obj_idx, n_real = self._encode_host(requests)
        return images[..., 0], Ks, obj_idx, n_real

    def collective_infer(self, images, Ks, obj_idx, n_real) -> List[dict]:
        """One serve step on a batch every rank holds (after the
        broadcast); the results of its ``n_real`` requests."""
        arrays = {"images": torch.as_tensor(np.asarray(images, np.float32)
                                            )[..., None],
                  "Ks": torch.as_tensor(np.asarray(Ks, np.float32)),
                  "obj_idx": torch.as_tensor(np.asarray(obj_idx, np.int64))}
        staged = serving._Staged(loader.Staged(arrays, None), int(n_real),
                                 False)
        return self._fetch(self._launch(staged), int(n_real))


def serve_forever(server: MultiHostPoseServer, image_shape,
                  next_batch: Optional[Callable[[], Optional[
                      Sequence[PoseRequest]]]] = None,
                  deliver: Optional[Callable[[List[dict]], None]] = None,
                  ) -> int:
    """Collective serve loop: every rank calls it and it returns (the
    number of batches served) when rank 0's ``next_batch`` returns None.

    ``image_shape``: the (H, W) of every request. ``next_batch`` and
    ``deliver`` are used on rank 0 only; the other ranks pass None."""
    B, (H, W) = server.batch_size, tuple(image_shape)
    is_root = comm.is_main_process()
    if is_root and next_batch is None:
        raise ValueError("rank 0 must provide next_batch")
    dev = comm.comm_device()
    header = torch.zeros(2, dtype=torch.int64, device=dev)  # stop, n_real
    images = torch.zeros((B, H, W), dtype=torch.float32, device=dev)
    Ks = torch.zeros((B, 3, 3), dtype=torch.float32, device=dev)
    obj_idx = torch.zeros(B, dtype=torch.int64, device=dev)
    served = 0
    while True:
        err: Optional[BaseException] = None
        if is_root:
            header.fill_(0)
            try:
                reqs = next_batch()
                if reqs is None:
                    header[0] = 1
                else:
                    im, k, idx, n_real = server.encode_batch(reqs)
                    if im.shape[1:3] != (H, W):
                        raise ValueError(
                            f"request images {im.shape[1:3]} != declared "
                            f"image_shape {(H, W)}")
                    images.copy_(torch.from_numpy(im))
                    Ks.copy_(torch.from_numpy(k))
                    obj_idx.copy_(torch.from_numpy(idx))
                    header[1] = n_real
            except BaseException as e:   # broadcast stop, then re-raise
                err = e
                header.fill_(0)
                header[0] = 1
        comm.broadcast(header, 0)
        if int(header[0]):
            if err is not None:
                raise err
            return served
        for t in (images, Ks, obj_idx):
            comm.broadcast(t, 0)
        results = server.collective_infer(images.cpu().numpy(),
                                          Ks.cpu().numpy(),
                                          obj_idx.cpu().numpy(),
                                          int(header[1]))
        served += 1
        if is_root and deliver is not None:
            deliver(results)
