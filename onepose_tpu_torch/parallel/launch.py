"""Worlds of processes for several cards, on ``torch.distributed``.

Counterpart of ``onepose_tpu/parallel/launch.py``. The JAX package runs
one process per host over all of its devices; the port runs one process
per card, torch's idiom, and a world of such ranks stands in for the
mesh:

- :func:`maybe_initialize` joins a world of several hosts when a
  coordinator is configured: the same keys and environment variables as
  the JAX package (``parallel.coordinator`` / ``num_processes`` /
  ``process_id``, or ``ONEPOSE_COORDINATOR`` / ``ONEPOSE_NUM_PROCESSES``
  / ``ONEPOSE_PROCESS_ID``; the config takes precedence), the same
  ``ValueError`` when one is missing, then
  ``init_process_group(init_method="tcp://<coordinator>")``. Each process
  is one rank and drives one card.
- :func:`run_local` spawns N ranks on this host, one card each, and
  returns what each rank's function returned: what an entry's
  ``n_devices=N`` does. The ranks meet through a ``TCPStore`` that the
  parent binds on a free port. NCCL connects them when every rank has a
  card of its own; where there are fewer cards than ranks (NCCL refuses
  two ranks on one card) they share the cards over gloo, and on the CPU
  they use gloo too.

Worker functions must be importable at module level (the spawn start
method: CUDA cannot fork).
"""
from __future__ import annotations

import io
import os
import queue
import time
import traceback
from typing import Callable, List, Optional

import torch
import torch.distributed as dist

from onepose_tpu_torch import runtime

ENV_KEYS = {"coordinator": "ONEPOSE_COORDINATOR",
            "num_processes": "ONEPOSE_NUM_PROCESSES",
            "process_id": "ONEPOSE_PROCESS_ID"}


def _cfg_or_env(parallel_cfg, key: str, env: str) -> Optional[str]:
    val = None
    if parallel_cfg is not None:
        val = parallel_cfg.get(key, None)
    if val is None:
        val = os.environ.get(env)
    return None if val in (None, "") else str(val)


def pick_backend(device_type: str, world: int, n_cards: int) -> str:
    """NCCL when each of ``world`` ranks has a card of its own, else
    gloo (ranks sharing a card, or the CPU)."""
    return "nccl" if device_type == "cuda" and n_cards >= world else "gloo"


def set_rank_device(device_type: str, rank: int) -> torch.device:
    """The device this rank computes on, made current: card ``rank mod
    cards`` (``LOCAL_RANK`` when set) on a card, else the CPU."""
    if device_type != "cuda":
        return torch.device("cpu")
    local = int(os.environ.get("LOCAL_RANK", rank))
    torch.cuda.set_device(local % torch.cuda.device_count())
    return torch.device("cuda", torch.cuda.current_device())


def maybe_initialize(parallel_cfg=None, device="cuda") -> bool:
    """Join the world of several hosts that the config (or environment)
    names; False, and nothing done, without a coordinator or when this
    process is already in a world."""
    coordinator = _cfg_or_env(parallel_cfg, "coordinator",
                              ENV_KEYS["coordinator"])
    if coordinator is None:
        return False
    num_processes = _cfg_or_env(parallel_cfg, "num_processes",
                                ENV_KEYS["num_processes"])
    process_id = _cfg_or_env(parallel_cfg, "process_id",
                             ENV_KEYS["process_id"])
    if num_processes is None or process_id is None:
        raise ValueError(
            "parallel.coordinator requires parallel.num_processes and "
            "parallel.process_id (or ONEPOSE_NUM_PROCESSES / "
            "ONEPOSE_PROCESS_ID)")
    if dist.is_initialized():
        return False
    device_type = torch.device(device).type
    rank, world = int(process_id), int(num_processes)
    set_rank_device(device_type, rank)
    dist.init_process_group(
        "nccl" if device_type == "cuda" else "gloo",
        init_method=f"tcp://{coordinator}", rank=rank, world_size=world)
    return True


def _dumps(obj) -> bytes:
    buf = io.BytesIO()
    torch.save(obj, buf)
    return buf.getvalue()


def _rank_main(rank: int, world: int, port: int, backend: str,
               device_type: str, threads: int, fn: Callable, args: tuple,
               results) -> None:
    """One spawned rank: its device and thread count, the world through
    the parent's store, ``fn(*args)``, and the outcome (serialized with
    ``torch.save``) or the traceback put on ``results``."""
    try:
        torch.set_num_threads(threads)
        set_rank_device(device_type, rank)
        store = dist.TCPStore("127.0.0.1", port, is_master=False)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world)
        out = fn(*args)
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
        raise
    results.put((rank, "ok", _dumps(out)))
    dist.destroy_process_group()


def run_local(fn: Callable, n_ranks: int, *args, device="cuda",
              timeout: Optional[float] = None, threads: int = 2) -> List:
    """Run ``fn(*args)`` on ``n_ranks`` spawned ranks of one world and
    return their results in rank order (tensors come back on the CPU).
    ``device`` names the kind of device the ranks compute on (``cuda``:
    card ``rank mod cards``). A rank that raises, exits early or outlasts
    ``timeout`` seconds makes this raise, and every rank is stopped."""
    import multiprocessing as mp

    device_type = runtime.resolve_device(device, "run_local").type
    n_cards = torch.cuda.device_count() if device_type == "cuda" else 0
    backend = pick_backend(device_type, n_ranks, n_cards)
    store = dist.TCPStore("127.0.0.1", 0, is_master=True,
                          wait_for_workers=False)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(
        rank, n_ranks, store.port, backend, device_type, threads, fn, args,
        results)) for rank in range(n_ranks)]
    for p in procs:
        p.start()
    deadline = None if timeout is None else time.monotonic() + timeout
    got = {}
    try:
        while len(got) < n_ranks:
            try:
                rank, status, payload = results.get(timeout=0.5)
            except queue.Empty:
                if deadline is not None and time.monotonic() > deadline:
                    late = sorted(set(range(n_ranks)) - set(got))
                    raise TimeoutError(f"run_local: ranks {late} did not "
                                       f"finish in {timeout} s")
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if r not in got and p.exitcode not in (None, 0)]
                if not dead:
                    continue
                try:    # the report a failed rank sent before it exited
                    rank, status, payload = results.get(timeout=2.0)
                except queue.Empty:
                    raise RuntimeError(f"run_local: rank {dead[0][0]} "
                                       f"exited with code {dead[0][1]}")
            if status == "error":
                raise RuntimeError(f"run_local: rank {rank} of {n_ranks} "
                                   f"({backend}) failed:\n{payload}")
            got[rank] = torch.load(io.BytesIO(payload), map_location="cpu",
                                   weights_only=False)
    finally:
        for p in procs:
            p.join(timeout=10 if len(got) == n_ranks else 0)
            if p.is_alive():
                p.terminate()
                p.join()
        results.close()
    return [got[r] for r in range(n_ranks)]
