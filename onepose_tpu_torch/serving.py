"""Multi-object pose serving on one device.

Port of ``onepose_tpu/serving.py`` without the mesh. All object DBs share
one static ``shape3d`` and ``num_leaf`` and stay resident on the device,
stacked [O, ...]; each request carries an object index, and the serve step
gathers each request's DB row (``index_select``), so a mixed-object batch
runs in one pass: SuperPoint extraction, GATsSPG matching through the
fused match kernel with a DB per batch element, batched LO-RANSAC PnP.

APIs: ``infer_batch`` (synchronous), ``infer_many`` (a staging thread
uploads batches ahead of the launches while results drain in a bounded
window) and ``start`` / ``submit`` / ``stop`` (a worker thread assembles
batches by size or latency and resolves futures). All three run the one
serve step, :func:`serve_step`.

On a card the staging thread (``runtime/loader.py``'s ``stage_ahead`` and
``DeviceStager``) uploads from pinned host memory on its own stream and
records an event; the launching thread's stream waits on that event
before the serve step reads the batch, and the batch's tensors are marked
as used on that stream so that their memory is not reused early.
"""
from __future__ import annotations

import contextlib
import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from onepose_tpu_torch.datasets.anno import ObjectDB
from onepose_tpu_torch.models import gats_spg, superpoint
from onepose_tpu_torch.ops import epnp
from onepose_tpu_torch.ops.precision import pin_fp32
from onepose_tpu_torch.pipeline import PoseOutput, frame_step
from onepose_tpu_torch.runtime import loader

DB_KEYS = ("keypoints3d", "descriptors3d", "descriptors2d_db", "mask3d")
DESCRIPTOR_KEYS = ("descriptors3d", "descriptors2d_db")
STORE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def serve_step(sp_model: superpoint.SuperPoint, gats_model: gats_spg.GATsSPG,
               db_stack: Dict[str, torch.Tensor], obj_idx: torch.Tensor,
               images: torch.Tensor, Ks: torch.Tensor, sp_config: dict,
               gats_config: dict, uniform: bool = False,
               **pnp_kw) -> PoseOutput:
    """One mixed-object batch. db_stack tensors are [O, ...]; obj_idx [B]
    int64; images [B, H, W, 1]; Ks [B, 3, 3]; ``pnp_kw`` go to
    :func:`pipeline.frame_step` (noise, generator, RANSAC settings).

    Each request's DB row is gathered, then the batch runs the pipeline's
    own frame step. ``uniform=True`` (the caller saw that every request
    names obj_idx[0]) takes that row once and expands it over the batch.
    Descriptors stored in bf16 are upcast after the gather: the gather
    moves half the bytes, the matcher computes in fp32."""
    b = obj_idx.shape[0]
    if uniform:
        rows = {k: v.index_select(0, obj_idx[:1]).expand(b, *v.shape[1:])
                for k, v in db_stack.items()}
    else:
        rows = {k: v.index_select(0, obj_idx) for k, v in db_stack.items()}
    return frame_step(sp_model, gats_model, rows, images, Ks, sp_config,
                      gats_config, **pnp_kw)


class PoseRequest(NamedTuple):
    object_name: str
    image: np.ndarray   # [H, W] grayscale in [0, 1]
    K: np.ndarray       # [3, 3]


class _Staged(NamedTuple):
    """An assembled batch: images [B, H, W, 1], Ks [B, 3, 3] and obj_idx
    [B] on the host, or on the card with the event of their upload."""
    arrays: loader.Staged
    n_real: int
    uniform: bool


class PoseServer:
    """Multi-object pose server on one device (the card unless the caller
    names another; without a card the default raises)."""

    def __init__(self, sp_model: superpoint.SuperPoint,
                 gats_model: gats_spg.GATsSPG,
                 object_dbs: Dict[str, ObjectDB],
                 sp_config: Optional[dict] = None,
                 gats_config: Optional[dict] = None,
                 batch_size: int = 8,
                 max_latency_s: float = 0.02,
                 reproj_threshold: float = 5.0,
                 num_hypotheses: int = 512,
                 refine_iters: int = 5,
                 seed: int = 0,
                 mesh=None,
                 db_dtype: str = "float32",
                 device: torch.device | str = "cuda"):
        """``db_dtype="bfloat16"`` stores the descriptor stacks in bf16:
        half the device memory per object and half the gather traffic;
        match sets can shift at threshold boundaries. keypoints3d stay fp32.
        A batch whose requests all name one object takes that object's DB
        row once (see :func:`serve_step`)."""
        if mesh is not None:
            raise NotImplementedError(
                "PoseServer(mesh=...): the PyTorch port serves on one device; "
                "multi-GPU serving is ROADMAP Queue 1 item 13")
        if not object_dbs:
            raise ValueError("need at least one object DB")
        shapes = {db.keypoints3d.shape[0] for db in object_dbs.values()}
        leaves = {db.num_leaf for db in object_dbs.values()}
        if len(shapes) != 1 or len(leaves) != 1:
            raise ValueError(
                "all object DBs must share shape3d and num_leaf "
                f"(got shapes {shapes}, num_leaf {leaves})")
        if db_dtype not in STORE_DTYPES:
            raise ValueError(f"db_dtype must be one of {sorted(STORE_DTYPES)}")
        pin_fp32()
        device = torch.device(device)
        if device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("PoseServer: no CUDA device; pass "
                                   "device='cpu' to run on the CPU")
            if device.index is None:
                # worker threads start on device 0: name the device
                device = torch.device("cuda", torch.cuda.current_device())
        self.device = device

        self.names = sorted(object_dbs)
        self.name_to_idx = {n: i for i, n in enumerate(self.names)}
        self.db_stack = {}
        for key in DB_KEYS:
            arr = torch.from_numpy(np.stack(
                [np.asarray(getattr(object_dbs[n], key)) for n in self.names]))
            if key in DESCRIPTOR_KEYS:
                arr = arr.to(STORE_DTYPES[db_dtype])
            self.db_stack[key] = arr.to(device)
        self.sp_model = sp_model.to(device).eval()
        self.gats_model = gats_model.to(device).eval()

        self.sp_config = dict(superpoint.DEFAULT_CONFIG)
        self.sp_config.update(sp_config or {})
        self.gats_config = gats_spg.resolve_config(gats_config)
        self.batch_size = batch_size
        self.max_latency_s = max_latency_s
        self.reproj_threshold = reproj_threshold
        self.num_hypotheses = num_hypotheses
        self.refine_iters = refine_iters
        self.generator = torch.Generator(device=device).manual_seed(seed)
        self._stager = loader.DeviceStager(device)

        self._queue: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._worker: Optional[threading.Thread] = None

    # -- batch assembly / launch / fetch ---------------------------------
    def _encode_host(self, requests: Sequence[PoseRequest]):
        """Pad a request list to the static batch size with copies of its
        last request and stack host arrays: images [B,H,W,1], Ks [B,3,3],
        obj_idx [B], and the count of real requests."""
        n_real = len(requests)
        reqs = list(requests)
        while len(reqs) < self.batch_size:
            reqs.append(reqs[-1])
        reqs = reqs[: self.batch_size]
        images = np.stack(
            [np.asarray(r.image, np.float32) for r in reqs])[..., None]
        Ks = np.stack([np.asarray(r.K, np.float32) for r in reqs])
        obj_idx = np.asarray(
            [self.name_to_idx[r.object_name] for r in reqs], np.int64)
        return images, Ks, obj_idx, n_real

    def _assemble(self, requests: Sequence[PoseRequest],
                  to_device: bool) -> _Staged:
        """Pad to the static batch size and, with ``to_device``, start the
        upload (``loader.DeviceStager``: pinned memory, a side stream)."""
        images, Ks, obj_idx, n_real = self._encode_host(requests)
        uniform = bool((obj_idx == obj_idx[0]).all())
        arrays = {"images": images, "Ks": Ks, "obj_idx": obj_idx}
        staged = (self._stager(arrays) if to_device else loader.Staged(
            {k: torch.from_numpy(v) for k, v in arrays.items()}, None))
        return _Staged(staged, n_real, uniform)

    def _launch(self, staged: _Staged,
                noise: Optional[epnp.RansacNoise] = None) -> PoseOutput:
        """Run the serve step on one assembled batch, on the calling
        thread's current stream. RANSAC's noise is ``noise`` when given,
        else drawn from the server's generator."""
        arrays = {k: t.to(self.device)
                  for k, t in staged.arrays.wait().items()}
        return serve_step(
            self.sp_model, self.gats_model, self.db_stack,
            arrays["obj_idx"], arrays["images"], arrays["Ks"],
            self.sp_config, self.gats_config, uniform=staged.uniform,
            noise=noise, generator=None if noise is not None
            else self.generator, reproj_threshold=self.reproj_threshold,
            num_hypotheses=self.num_hypotheses,
            refine_iters=self.refine_iters)

    @staticmethod
    def _fetch(out: PoseOutput, n_real: int) -> List[dict]:
        poses = out.poses.cpu().numpy()
        success = out.success.cpu().numpy()
        inliers = out.num_inliers.cpu().numpy()
        return [
            {"pose": poses[i] if success[i] else None,
             "num_inliers": int(inliers[i]),
             "success": bool(success[i])}
            for i in range(n_real)
        ]

    # -- synchronous API ------------------------------------------------
    def run(self, requests: Sequence[PoseRequest],
            noise: Optional[epnp.RansacNoise] = None) -> PoseOutput:
        """The serve step's whole output for one batch (padded to
        ``batch_size``), on the device."""
        return self._launch(self._assemble(requests, to_device=False), noise)

    def infer_batch(self, requests: Sequence[PoseRequest],
                    noise: Optional[epnp.RansacNoise] = None) -> List[dict]:
        """Run a mixed-object batch synchronously; one result per request.
        ``noise`` ([batch_size, ...] rows of :class:`epnp.RansacNoise`)
        replaces the draw from the server's generator."""
        return self._fetch(self.run(requests, noise), len(requests))

    def infer_many(self, requests: Sequence[PoseRequest],
                   depth: int = 2, max_in_flight: int = 4) -> List[dict]:
        """Pipelined inference over many requests: a staging thread
        assembles batches and starts their uploads up to ``depth`` ahead,
        each staged batch launches as soon as it is ready, and results are
        fetched in a window of ``max_in_flight`` batches, so that the
        upload of batch N+1, the compute of batch N and the fetch of batch
        N-k overlap."""
        chunks = [list(requests[i:i + self.batch_size])
                  for i in range(0, len(requests), self.batch_size)]
        results: List[dict] = []
        pending: List = []
        with self._on_device():
            for item in loader.stage_ahead(
                    iter(chunks),
                    lambda chunk: self._assemble(chunk, to_device=True),
                    depth):
                pending.append((self._launch(item), item.n_real))
                if len(pending) > max_in_flight:
                    results.extend(self._fetch(*pending.pop(0)))
            for out, n_real in pending:
                results.extend(self._fetch(out, n_real))
        return results

    def _on_device(self):
        """Context that makes the server's card the calling thread's
        current device (a no-op off the card)."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    # -- async API ------------------------------------------------------
    def start(self):
        self._worker = threading.Thread(target=self._serve_loop,
                                        daemon=True)
        self._worker.start()

    def stop(self):
        self._stop.set()
        if self._worker is not None:
            self._worker.join(timeout=5)

    def submit(self, request: PoseRequest) -> Future:
        fut: Future = Future()
        self._queue.put((request, fut))
        return fut

    def _serve_loop(self):
        with self._on_device():
            while not self._stop.is_set():
                batch: List = []
                try:
                    batch.append(self._queue.get(timeout=0.05))
                except queue.Empty:
                    continue
                # batch up to the batch size or the latency budget
                deadline = time.monotonic() + self.max_latency_s
                while len(batch) < self.batch_size:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    try:
                        batch.append(self._queue.get(timeout=remaining))
                    except queue.Empty:
                        break
                futs = [b[1] for b in batch]
                try:
                    results = self.infer_batch([b[0] for b in batch])
                except Exception as e:  # resolve every future, keep serving
                    for fut in futs:
                        fut.set_exception(e)
                    continue
                for fut, res in zip(futs, results):
                    fut.set_result(res)

