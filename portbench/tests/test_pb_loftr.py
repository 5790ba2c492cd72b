"""The detect-loftr cell on the CPU at a small size: LoFTR's operation
counts against FlopCounterMode, the frozen reference equal to the
port's, a sound run reading ``correct`` with every result key, faults of
LoFTR's own that must read incorrect (the fine stage skipped, feat1's
cross update taken from the old feat0, the mask applied before the
maxima), no forbidden module loaded; and on the card the TF32 control
failing the cell's limits."""
from __future__ import annotations

import subprocess
import sys

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import flops, flops_loftr, judge
from portbench.manifest import ROOT
from portbench.run import run_cell
from portbench.tests.small import small_work

NAME = "detect-loftr-fp32-15views"
SMALL = {"config_data": {"n_ref_view": 3, "view": [64, 64],
                         "frame": [96, 128]},
         "traffic_data": {"pool": 3, "warmup_frames": 1, "trace_frames": 1,
                          "check_frames": 2, "check_from": 2}}
SEED = 2 ** 32 + 11


def counted(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.mark.parametrize("v,view,frame", [(2, (64, 64), (96, 128)),
                                          (1, (32, 48), (64, 64))])
def test_flops_against_the_counter(v, view, frame):
    from onepose_tpu_torch.models import loftr

    cfg = loftr.resolve_config()
    torch.manual_seed(0)
    sd = loftr.LoFTR().state_dict()
    views, img = torch.rand(v, 1, *view), torch.rand(1, 1, *frame)
    holder = []
    assert counted(lambda: holder.append(loftr.Matcher(sd, views, cfg))) \
        == flops_loftr.views(v, *view, cfg)
    assert counted(lambda: holder[0](img)) == flops_loftr.frame(
        v, view, frame, cfg)
    p = loftr.prepare(sd)
    assert counted(lambda: loftr.backbone(p, img)) == \
        flops_loftr.backbone(1, *frame)


def test_the_whole_frame_at_the_cell_shape():
    from onepose_tpu_torch.models import loftr

    cfg = loftr.resolve_config()
    n = flops_loftr.frame(15, (512, 512), (1440, 1920), cfg)
    assert flops.match(15, 4096, 43200, 256) == 2 * 15 * 4096 * 43200 * 256
    assert 13.7e12 < n < 13.8e12


def test_the_reference_is_a_frozen_copy():
    a = (ROOT / "onepose_tpu_torch" / "reference" / "loftr.py").read_bytes()
    b = (ROOT / "portbench" / "reference" / "loftr.py").read_bytes()
    assert a == b


def test_sound_run_reads_correct_with_every_key():
    work = small_work(NAME, SMALL)
    result = run_cell(work, SEED, 0.5, False, "cpu")
    assert result["correct"] is True, result["check"]
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"] and list(result)[-1] == "check"
    assert {m["name"] for m in work["end_to_end"]} == set(result["metrics"])
    assert set(result["check"]) == set(work["config_data"]["limits"])


def _fine_skipped(monkeypatch):
    from onepose_tpu_torch.models import loftr

    def broken(self, fine1, feat0, feat1, j, w1):
        return loftr.cell_points(j, w1, self.coarse_stride)

    monkeypatch.setattr(loftr.Matcher, "fine", broken)


def _cross_from_old_feat0(monkeypatch):
    from onepose_tpu_torch.models import loftr

    def broken(p, name, layer_names, f0, f1, heads):
        for i, kind in enumerate(layer_names):
            layer = f"{name}.layers.{i}"
            s0, s1 = (f0, f1) if kind == "self" else (f1, f0)
            f0, f1 = (loftr.encoder_layer(p, layer, f0, s0, heads),
                      loftr.encoder_layer(p, layer, f1, s1, heads))
        return f0, f1

    monkeypatch.setattr(loftr, "transformer", broken)


def _mask_before_maxima(monkeypatch):
    from onepose_tpu_torch.models import loftr

    def broken(feat0, feat1, hw0, hw1, cfg):
        mc = cfg["match_coarse"]
        s = torch.einsum("bnd,bmd->bnm", feat0, feat1) / (
            feat0.shape[-1] * mc["dsmax_temperature"])
        conf = torch.softmax(s, 1) * torch.softmax(s, 2)
        b = mc["border_rm"]
        keep = (loftr.interior(*hw0, b)[:, None]
                & loftr.interior(*hw1, b)[None]) & (conf > mc["thr"])
        conf = conf * keep
        max0, j = conf.max(2)
        i = torch.arange(conf.shape[1])
        mutual = conf.argmax(1).gather(1, j) == i
        return loftr.CoarseMatches((max0 > mc["thr"]) & mutual, j, max0)

    monkeypatch.setattr(loftr, "coarse_match", broken)


@pytest.mark.parametrize("fault", [_fine_skipped, _cross_from_old_feat0],
                         ids=lambda f: f.__name__)
def test_fault_reads_incorrect(monkeypatch, fault):
    fault(monkeypatch)
    result = run_cell(small_work(NAME, SMALL), SEED, 0.5, False, "cpu")
    assert result["correct"] is False, result["check"]


def test_mask_before_maxima_reads_incorrect(monkeypatch):
    """The pasted scene's conf is too peaked for the mask's order to
    matter (no masked cell holds the maximum of a row whose other cells
    pass the threshold), so the judge is given a frame whose transformer
    output has the frame cell of its surest match copied into a frame
    corner cell, scaled so that S is 0.5 above the match's own (which
    keeps a conf near 0.38 there): LoFTR's rule leaves the view cell
    unmatched, a rule that
    masks before the maxima matches it to its own cell. The judge reads
    the first slate as sound and the second as moved beyond the limit."""
    from onepose_tpu_torch.models import loftr
    from portbench.drivers.detect_loftr_closed import Cell
    from portbench.reference import loftr as ref

    work = small_work(NAME, SMALL)
    cell = Cell(work, SEED, "cpu")
    cell.setup()
    img = torch.from_numpy(cell.scene["frames"][0])[None, None]
    kept = {}
    m = cell.det.matcher(img, kept)
    b, i = divmod(int(m.conf.masked_fill(~m.valid, 0).argmax()),
                  m.valid.shape[1])
    f0, f1 = kept["feat0"][b, i], kept["feat1"][b, int(m.j[b, i])]
    s = float(f0 @ f1) / (256 * 0.1)
    kept["feat1"][b, 0] = f1 * (1 + 0.5 / s)
    hw0, hw1 = cell.det.matcher.hw0, tuple(kept["coarse1"].shape[2:])
    cell.release()
    ref_c0, ref_f0 = ref.backbone(cell.sd, cell.views)
    tok0 = ref.add_position_encoding(ref_c0)
    moved = []
    for fault in (None, _mask_before_maxima):
        if fault:
            fault(monkeypatch)
        c = loftr.coarse_match(kept["feat0"], kept["feat1"], hw0, hw1,
                               cell.lcfg)
        r = cell.judge_frame(img, kept, m._replace(valid=c.valid, j=c.j,
                                                   conf=c.conf),
                             cell.view_tokens, tok0, ref_f0)
        moved.append(judge.merge([r])["match_moved"])
    limit = work["config_data"]["limits"]["match_moved"]
    assert moved[0] == 0.0 and moved[1] > limit, moved


def test_a_run_loads_no_forbidden_module():
    code = (
        "from portbench.tests.test_pb_loftr import NAME, SMALL\n"
        "from portbench.tests.small import small_work\n"
        "from portbench.run import run_cell\n"
        "from portbench.common import forbidden_modules\n"
        "run_cell(small_work(NAME, SMALL), 3, 0.5, False, 'cpu')\n"
        "print(forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.cuda
def test_control_fails_and_program_passes():
    """At the cell's own shapes, two frames checked."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from portbench.calibrate import readings

    work = small_work(NAME, {"traffic_data": {"warmup_frames": 1,
                                              "check_frames": 2,
                                              "check_from": 2}})
    limits = work["config_data"]["limits"]
    got = readings(work, 2 ** 31 + 77, 1.0, True)
    assert got["checked"] > 0
    assert judge.verdict(got["program"], limits)[0], got["program"]
    assert not judge.verdict(got["control"], limits)[0], got["control"]
