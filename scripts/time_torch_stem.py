#!/usr/bin/env python
"""Time the PyTorch port's stem kernel on one NVIDIA card, for A/B runs.

    python3 scripts/time_torch_stem.py [ROOT ...]

For each ROOT (a checkout of this repository, default the one holding this
script), in a process of its own: build that tree's kernels, run its
``fused_stem`` at [8,512,512,1] on seeded inputs, print its max|Δ| against
the plain fp32 version and, with the plain version's, against an fp64
reference, then three CUDA-event means of 20 calls after 3 warm-up calls.
Roots run in the order given, so "A B B A" interleaves two versions.
"""
import os
import subprocess
import sys

_CHILD = r"""
import numpy as np, torch
from onepose_tpu_torch.ops import _kernels, stem
from onepose_tpu_torch.ops.precision import pin_fp32

pin_fp32()
path = _kernels.build()
for line in path.with_name(path.name + ".log").read_text().splitlines():
    if "registers" in line or "spill" in line:
        print("ptxas:", line.strip())
rng = np.random.default_rng(0)
shape = (8, 512, 512, 1)
arrs = (rng.uniform(0, 1, shape), rng.normal(size=(3, 3, 1, 64)) * 0.3,
        rng.normal(size=64) * 0.1, rng.normal(size=(3, 3, 64, 64)) * 0.06,
        rng.normal(size=64) * 0.1)
args = [torch.from_numpy(a.astype(np.float32)).cuda() for a in arrs]
got, ref = stem.fused_stem(*args), stem.stem_reference(*args)
ref64 = stem.stem_reference(*(a.double() for a in args))
print("max|d| vs plain", float((got - ref).abs().max()),
      "vs fp64: kernel", float((got.double() - ref64).abs().max()),
      "plain", float((ref.double() - ref64).abs().max()))
del ref64
start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
for _ in range(3):
    for _ in range(3):
        stem.fused_stem(*args)
    torch.cuda.synchronize()
    start.record()
    for _ in range(20):
        stem.fused_stem(*args)
    end.record()
    torch.cuda.synchronize()
    print("ms", start.elapsed_time(end) / 20)
"""


def main() -> int:
    roots = sys.argv[1:] or [os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    rc = 0
    for root in roots:
        print(f"== {root}", flush=True)
        rc |= subprocess.run([sys.executable, "-c", _CHILD],
                             cwd=os.path.abspath(root)).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
