#!/usr/bin/env python
"""The largest batch of 4x4 symmetric systems ``torch.linalg.eigh`` takes
in one call on this machine's card (fp32), and the time a call of each
size takes, by CUDA events.

    python3 scripts/torch_eigh_batch_limit.py

Prints one line a batch size (2^12 to 2^22): ok or the error's first
line, and the ms of one call. ``sfm/triangulate.py::EIGH_BATCH`` must
stay at or below the largest size that passes.
"""
import sys

import torch


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(torch.cuda.get_device_name(0), torch.__version__, torch.version.cuda)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for k in range(12, 23):
        a = torch.randn((1 << k, 4, 4), device="cuda", generator=gen)
        a = a @ a.transpose(1, 2)
        try:
            torch.linalg.eigh(a)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            torch.linalg.eigh(a)
            end.record()
            end.synchronize()
            print(f"2^{k}: ok, {start.elapsed_time(end):.3f} ms")
        except RuntimeError as e:
            print(f"2^{k}: {str(e).splitlines()[0][:160]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
