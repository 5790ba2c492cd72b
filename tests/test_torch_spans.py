"""The port's own spans (``utils/profiling.span``), on the CPU.

Without a profiler a span is one shared null context; under
``profiling.trace`` (every host thread) each span of the table in
``utils/profiling.py`` is recorded on the thread that runs its work,
inside its parent. The outputs are bit-equal with the profiler on and
off: a span adds no work. The worlds are tiny: random weights, a random
object DB, 64x64 frames, 64 keypoints.
"""
import concurrent.futures as cf
import contextlib

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from onepose_tpu_torch import detector as tdetector
from onepose_tpu_torch import pipeline as tpipe
from onepose_tpu_torch.models import gats_spg, superglue, superpoint
from onepose_tpu_torch.ops import epnp
from onepose_tpu_torch.runtime.loader import DeviceStager, stage_ahead
from onepose_tpu_torch.utils import profiling, synthetic

K_MAX = 64
PNP = dict(num_hypotheses=32, refine_iters=2)

# each span of the program and the span it sits in (None: outermost)
PARENTS = {
    "loader.stage": None,
    "loader.wait": None,
    "extract": None,
    "extract.stem": "extract",
    "extract.encoder": "extract",
    "extract.select": "extract",
    "match": None,
    "match.gnn": "match",
    "match.kernel": "match",
    "pnp": None,
    "pnp.solve": "pnp",
    "pnp.score": "pnp",
    "pnp.lo": "pnp",
    "pnp.refit": "pnp",
    "pnp.polish": "pnp",
    "superglue": None,
    "superglue.gnn": "superglue",
    "superglue.sinkhorn": "superglue",
    "superglue.mutual": "superglue",
    "fit": None,
    "box": None,
}


@pytest.fixture(scope="module")
def world():
    torch.manual_seed(0)
    rng = np.random.default_rng(0)
    sp = superpoint.SuperPoint()
    pipe = tpipe.PosePipeline(
        sp, gats_spg.GATsSPG(num_blocks=2),
        synthetic.random_db(rng, 40, 48, 4), sp_config={"max_keypoints": K_MAX},
        gats_config={"match_threshold": 1e-3}, device="cpu", **PNP)
    views = [rng.uniform(0, 1, (64, 64)).astype(np.float32)
             for _ in range(3)]
    det = tdetector.LocalFeatureObjectDetector(
        sp, superglue.SuperGlue(num_gnn_layers=2), views,
        sg_config={"sinkhorn_iterations": 5}, max_keypoints=K_MAX,
        device="cpu")
    images = torch.from_numpy(
        rng.uniform(0, 1, (2, 64, 64, 1)).astype(np.float32))
    Ks = torch.from_numpy(np.broadcast_to(
        synthetic.pinhole(64, 60.0).astype(np.float32), (2, 3, 3)).copy())
    gen = torch.Generator().manual_seed(1)
    noise = epnp.draw_noise(2, K_MAX, PNP["num_hypotheses"], 64, gen)
    frame = views[1].copy()
    frame_noise = torch.rand((3, 256, K_MAX), generator=gen)
    batches = [{"images": rng.uniform(0, 1, (2, 8, 8, 1)).astype(np.float32),
                "Ks": np.eye(3, dtype=np.float32)[None].repeat(2, 0)}
               for _ in range(3)]
    return dict(pipe=pipe, det=det, images=images, Ks=Ks, noise=noise,
                frame=frame, frame_noise=frame_noise, batches=batches)


def _pipeline(w):
    out = w["pipe"].run_rows(w["images"], w["Ks"], noise=w["noise"])
    return list(out)


def _detector(w):
    """The detector's steps, as ``detect_bbox`` runs them, with each
    step's outputs."""
    det, img = w["det"], w["frame"]
    with torch.no_grad():
        q = det.extract(torch.as_tensor(img)[None, :, :, None])
        data = det.match_data(q, img.shape)
        Z = superglue.log_assignment(det.sg_model, data, det.sg_config)
        m = superglue.mutual_matches(Z, det.sg_config["match_threshold"],
                                     data["mask0"], data["mask1"])
        fits = det.fit(q, m, w["frame_noise"])
        box, inliers = det.box(fits, img.shape)
    return [*q, Z, *m, *fits, torch.from_numpy(box), torch.tensor(inliers)]


def _loader(w):
    staged = list(stage_ahead(iter(w["batches"]), DeviceStager("cpu")))
    return [t for s in staged for t in s.wait().values()]


PATHS = {"pipeline": _pipeline, "detector": _detector, "loader": _loader}


def _pool_extract(w):
    """Extraction on a pool thread, as a pipelined caller runs it."""
    with cf.ThreadPoolExecutor(1) as pool:
        return list(pool.submit(w["pipe"].extract, w["images"]).result())


@pytest.fixture(scope="module")
def recorded(world, tmp_path_factory):
    """Every path once under ``profiling.trace``: → (the outputs by path,
    the spans [(name, thread, start, end)], the main thread's id)."""
    log_dir = tmp_path_factory.mktemp("trace")
    with profiling.trace(str(log_dir)) as prof:
        outs = {name: fn(world) for name, fn in PATHS.items()}
        outs["pool"] = _pool_extract(world)
    assert (log_dir / "trace.json").stat().st_size > 0
    spans = [(e.name[len(profiling.SPAN_PREFIX):], e.thread,
              e.time_range.start, e.time_range.end) for e in prof.events()
             if e.name.startswith(profiling.SPAN_PREFIX)
             and e.device_type == DeviceType.CPU]
    main = {t for n, t, _, _ in spans if n == "pnp"}
    assert len(main) == 1
    return outs, spans, main.pop()


def _parent(span, spans):
    """The innermost span that holds ``span`` on its thread."""
    name, thread, s, e = span
    around = [x for x in spans if x is not span and x[1] == thread
              and x[2] <= s and e <= x[3]]
    return max(around, key=lambda x: x[2])[0] if around else None


def test_span_is_one_shared_null_context_without_a_profiler():
    assert not torch.autograd.profiler._is_profiler_enabled
    first = profiling.span("pnp")
    assert isinstance(first, contextlib.nullcontext)
    assert all(profiling.span(n) is first for n in PARENTS)


@pytest.mark.parametrize("on_thread", [False, True])
def test_span_records_while_any_profile_runs(tmp_path, on_thread):
    """On the profiling thread and on another one (the thread-local flag
    reads False there under a profile of every thread)."""
    def kind():
        return type(profiling.span("pnp"))

    with profiling.trace(str(tmp_path)):
        if on_thread:
            with cf.ThreadPoolExecutor(1) as pool:
                got = pool.submit(kind).result()
        else:
            got = kind()
    assert got is not contextlib.nullcontext
    assert isinstance(profiling.span("pnp"), contextlib.nullcontext)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_outputs_bit_equal_with_the_profiler_on_and_off(world, recorded,
                                                        path):
    on = recorded[0][path]
    off = PATHS[path](world)
    assert len(on) == len(off)
    for a, b in zip(on, off):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("name", sorted(PARENTS))
def test_every_span_appears_inside_its_parent(recorded, name):
    spans = recorded[1]
    mine = [s for s in spans if s[0] == name]
    assert mine, f"no span {name}"
    assert {_parent(s, spans) for s in mine} == {PARENTS[name]}


def test_pnp_children_in_order(recorded):
    spans, main = recorded[1], recorded[2]
    pnp = [s for s in spans if s[0] == "pnp"]
    assert len(pnp) == 1
    _, _, s, e = pnp[0]
    children = sorted((x for x in spans if x[0].startswith("pnp.")
                       and x[1] == main and s <= x[2] and x[3] <= e),
                      key=lambda x: x[2])
    assert [x[0] for x in children] == [
        "pnp.solve", "pnp.score", "pnp.lo", "pnp.refit", "pnp.polish"]


def test_loader_spans_on_the_staging_and_the_consumer_threads(recorded):
    spans, main = recorded[1], recorded[2]
    stage = {t for n, t, _, _ in spans if n == "loader.stage"}
    wait = {t for n, t, _, _ in spans if n == "loader.wait"}
    assert wait == {main}
    assert len(stage) == 1 and main not in stage
    # a wait for each batch and one for the end of the source
    assert sum(n == "loader.wait" for n, *_ in spans) == 4
    assert sum(n == "loader.stage" for n, *_ in spans) == 3


def test_extract_recorded_on_a_pool_thread(world, recorded):
    spans, main = recorded[1], recorded[2]
    threads = {t for n, t, _, _ in spans if n == "extract"}
    assert main in threads and len(threads - {main}) >= 1
    for a, b in zip(recorded[0]["pool"], world["pipe"].extract(
            world["images"])):
        assert torch.equal(a, b)
