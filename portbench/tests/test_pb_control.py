"""The control on the card: the plain reference run with TF32 in the
program's place, judged as the program is, fails the cell's limits,
while the program passes them. At the configurations' widths, with a
smaller batch and fewer frames checked. ``portbench/calibrate.py`` reads
the same at the cells' own size on many seeds (the upper readings)."""
from __future__ import annotations

import pytest

from portbench import judge
from portbench.tests.small import small_work

SIZES = {
    "pose-fp32-b128": {"traffic_data": {"batch": 16, "pool": 16,
                                       "warmup_batches": 1, "check_batches": 1,
                                       "check_from": 1}},
    "detect-fp32-15views": {"traffic_data": {"warmup_frames": 1,
                                             "check_frames": 1,
                                             "check_from": 1}},
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SIZES))
def test_control_fails_and_program_passes(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from portbench.calibrate import readings

    work = small_work(name, SIZES[name])
    limits = work["config_data"]["limits"]
    got = readings(work, 2 ** 31 + 77, 1.0, True)
    assert got["checked"] > 0
    assert judge.verdict(got["program"], limits)[0], got["program"]
    assert not judge.verdict(got["control"], limits)[0], got["control"]
