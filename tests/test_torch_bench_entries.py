"""The port's measurement entries against the JAX-side files they port, on
the CPU at a reduced shape (batch 2, 128x128, K=128, shape3d 256, GATsSPG
at 2 blocks, one counted block).

Each entry's JSON line has the key set of the JAX file's (read from its
source with ``ast``; for ``scripts/profile_stages.py`` and
``scripts/bench_train.py``, which print lines, their rows' names), and
``device``; every number in it is finite (``mfu`` and ``roofline`` are
null off an H100). The demo chain's steps and overrides are those of
``scripts/demo_pipeline.sh``; it runs end to end only under ``slow``.
"""
import ast
import math
import os
import re
import shlex

import numpy as np
import pytest
import torch

from onepose_tpu_torch import (bench, bench_serving, bench_tracker,
                               bench_train, demo_pipeline, profile_stages)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(batch=2, hw=128, max_keypoints=128, shape3d=256,
             gats_config={"num_blocks": 2})


def _tree(rel):
    return ast.parse(open(os.path.join(REPO, rel)).read(), rel)


def _dumped_keys(rel):
    """The constant keys of each dict literal passed to ``json.dumps``."""
    return [{k.value for k in node.args[0].keys}
            for node in ast.walk(_tree(rel))
            if isinstance(node, ast.Call)
            and getattr(node.func, "attr", None) == "dumps"
            and isinstance(node.args[0], ast.Dict)]


def _tracker_keys():
    """bench_tracker.py's ``out`` dict and the keys it adds to it."""
    keys = set()
    for node in ast.walk(_tree("scripts/bench_tracker.py")):
        if isinstance(node, ast.Assign) and isinstance(node.targets[0],
                                                       ast.Name) \
                and node.targets[0].id == "out" \
                and isinstance(node.value, ast.Dict):
            keys |= {k.value for k in node.value.keys}
        if isinstance(node, ast.Assign) and isinstance(node.targets[0],
                                                       ast.Subscript) \
                and getattr(node.targets[0].value, "id", None) == "out":
            keys.add(node.targets[0].slice.value)
    return keys


def _profile_rows():
    """The row names that profile_stages.py reports, its f-string's loop
    values expanded."""
    tree = _tree("scripts/profile_stages.py")
    loops = {n.target.id: [e.value for e in n.iter.elts]
             for n in ast.walk(tree) if isinstance(n, ast.For)
             and isinstance(n.target, ast.Name)
             and isinstance(n.iter, ast.Tuple)}
    rows = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and getattr(node.func, "id", None) == "report"):
            continue
        arg = node.args[0]
        if isinstance(arg, ast.Constant):
            rows.append(arg.value)
        else:   # f"pnp {nh} hypotheses"
            var = next(v.value.id for v in arg.values
                       if isinstance(v, ast.FormattedValue))
            rows += ["".join(str(x) if isinstance(p, ast.FormattedValue)
                             else p.value for p in arg.values)
                     for x in loops[var]]
    return set(rows)


def _train_rows():
    """bench_train.py's printed names: its epoch modes and the ceiling."""
    tree = _tree("scripts/bench_train.py")
    rows = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.For) and isinstance(node.iter, ast.Tuple) \
                and isinstance(node.target, ast.Tuple):
            rows |= {e.elts[0].value.strip() for e in node.iter.elts}
        if isinstance(node, ast.JoinedStr) and isinstance(
                node.values[0], ast.Constant) and "ceiling" in \
                node.values[0].value:
            rows.add(node.values[0].value.split(":")[0].strip())
    return rows


def _finite(value, path=""):
    """Paths of the numbers in ``value`` that are not finite, and of its
    None values."""
    if isinstance(value, dict):
        return sum((_finite(v, f"{path}.{k}") for k, v in value.items()), [])
    if isinstance(value, list):
        return sum((_finite(v, f"{path}[{i}]") for i, v in enumerate(value)),
                   [])
    if value is None:
        return [path]
    if isinstance(value, (int, float)) and not isinstance(value, bool):
        return [] if math.isfinite(value) else [path]
    return []


def _bench(tmp_path):
    out = bench.run(**SMALL, n_iters=2, blocks=1, device="cpu")
    assert set(out) == _dumped_keys("bench.py")[0] | {"device"}
    assert out["blocks"] == 1 and out["stem_dtype"] == "bfloat16"
    # the stages split the calls of the block that the total is taken from
    assert sum(out["stages"][k] for k in ("extract_ms", "match_ms",
                                          "pnp_ms")) == pytest.approx(
        out["stages"]["total_ms"], rel=0.05)
    return [out], {".mfu", ".roofline"}


def _profile(tmp_path):
    out = profile_stages.run(**SMALL, n_iters=1, blocks=1, device="cpu",
                             log=lambda *a: None)
    assert set(out["rows"]) == _profile_rows()
    assert list(out["rows"])[0] == "sp stem (conv1a+1b+pool)"
    return [out], set()


def _serving(tmp_path):
    lines = []
    for flags in ([], ["--uniform"], ["--latency", "--latency-requests",
                                      "2"]):
        args = bench_serving.parser().parse_args(
            ["--n-objects", "3", "--device", "cpu", *flags])
        lines.append(bench_serving.run(
            args, **SMALL, num_hypotheses=32, n_iters=1, blocks=1,
            log=lambda *a: None))
    latency, saturation = _dumped_keys("scripts/bench_serving.py")
    for out in lines[:2]:
        assert set(out) == saturation | {"device"}
    assert lines[1]["uniform"] and not lines[0]["uniform"]
    assert set(lines[2]) == latency | {"device"}
    assert len(lines[2]["points"]) == len(bench_serving.LOAD_FRACTIONS)
    return lines, set()


def _tracker(tmp_path):
    args = bench_tracker.parser().parse_args(
        ["--frames", "4", "--warmup", "2", "--breakdown", "--uint8",
         "--device", "cpu"])
    out = bench_tracker.run(args, n_points=100, hw=128, n_slots=128,
                            log=lambda *a: None)
    assert set(out) == _tracker_keys() | {"device"}
    assert out["frames"] == 2
    assert set(out["breakdown"]) == {f"{s}_ms" for s in bench_tracker.STAGES
                                     } | {"rtt_ms", "upload_ms",
                                          "upload_bytes"}
    return [out], set()


def _train(tmp_path):
    out = bench_train.run(str(tmp_path / "train"), batch=2, shape2d=64,
                          shape3d=128, gats_config={"num_blocks": 2},
                          epochs=1, ceiling_steps=2, device="cpu",
                          log=lambda *a: None, n_points=128, n_images=4,
                          n2d=64)
    assert set(out) == _train_rows() | {"device"}
    return [out], set()


@pytest.mark.parametrize("entry", [_bench, _profile, _serving, _tracker,
                                   _train],
                         ids=["bench", "profile_stages", "bench_serving",
                              "bench_tracker", "bench_train"])
def test_entry_keys_and_finite_values(entry, tmp_path):
    lines, may_be_null = entry(tmp_path)
    for out in lines:
        assert out["device"] == "cpu"
        assert set(_finite(out)) <= may_be_null, _finite(out)


def test_chip_smoke_holds_the_same_key_sets():
    """chip_smoke.py phase 18 checks the lines on the card against its own
    copies of these key sets (the card's machine reads no JAX source)."""
    import chip_smoke

    latency, saturation = _dumped_keys("scripts/bench_serving.py")
    assert chip_smoke.BENCH_KEYS == _dumped_keys("bench.py")[0] | {"device"}
    assert set(chip_smoke.PROFILE_ROWS) == _profile_rows()
    assert chip_smoke.SERVING_KEYS == saturation | {"device"}
    assert chip_smoke.SERVING_LATENCY_KEYS == latency | {"device"}
    assert chip_smoke.TRACKER_KEYS == _tracker_keys() | {"device"}
    assert chip_smoke.TRAIN_KEYS == _train_rows() | {"device"}


def test_entries_refuse_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.run(**SMALL, device="cuda")


def _shell_chain(obj, tracking, cwd):
    """scripts/demo_pipeline.sh's python commands, its variables expanded:
    [(script, argv)]."""
    text = open(os.path.join(REPO, "scripts", "demo_pipeline.sh")).read()
    text = text.replace("\\\n", " ")
    env = {"OBJ_NAME": obj, "DATA_ROOT": f"data/demo/{obj}",
           "TRACKING": str(tracking)}
    out = []
    for line in text.splitlines():
        line = line.strip()
        if not line.startswith("python "):
            continue
        line = line.replace("$(pwd)", cwd)
        for k, v in env.items():
            line = line.replace("${%s}" % k, v)
        line = re.sub(r'\$\(dirname "([^"]*)"\)',
                      lambda m: os.path.dirname(m.group(1)), line)
        argv = shlex.split(line)
        out.append((argv[1], argv[2:]))
    return out


@pytest.mark.parametrize("tracking", [False, True])
def test_demo_chain_is_the_shell_script(tracking, tmp_path, monkeypatch):
    """The same three steps with the same overrides (paths made absolute;
    the SfM list in the capture's directory, as the same file name), the
    list naming the annotate sequence, each step's ``main`` called in
    this process."""
    monkeypatch.chdir(tmp_path)
    obj = "0600-toy-box"
    shell = _shell_chain(obj, tracking, str(tmp_path))
    port = demo_pipeline.commands(obj, tracking)
    assert [m for _, m, _ in port] == [s[:-3] for s, _ in shell]
    for (_, _, got), (_, ref) in zip(port, shell):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            gk, _, gv = g.rpartition("=")
            rk, _, rv = r.rpartition("=")
            assert gk == rk
            if rk == "dataset.data_list":
                assert os.path.basename(gv) == os.path.basename(rv)
            elif os.sep in rv:
                assert gv == os.path.abspath(rv)
            else:
                assert gv == rv

    (tmp_path / "data" / "demo" / obj).mkdir(parents=True)
    called = []
    for _, module, _ in port:
        mod = __import__(f"onepose_tpu_torch.{module}", fromlist=["main"])
        monkeypatch.setattr(mod, "main", lambda argv, m=module: called.append(
            (m, argv)))
    demo_pipeline.main([obj] + (["--WITH_TRACKING"] if tracking else []))
    assert called == [(m, a) for _, m, a in port]
    listed = open(port[1][2][1].split("=", 1)[1]).read()
    assert listed == f"{obj} {obj}-annotate\n"


@pytest.mark.slow
def test_demo_chain_end_to_end(tmp_path, monkeypatch):
    """The chain on a raw capture (20 annotate views, 3 test frames of the
    textured plane as mp4v video), SuperGlue planted at 2 layers and
    GATsSPG at 1 block, on the CPU: the DB and the demo's video written
    (about 90 s)."""
    pytest.importorskip("cv2")
    from onepose_tpu_torch.models import convert, superpoint
    from onepose_tpu_torch.sfm import extract
    from onepose_tpu_torch.utils import synthetic

    monkeypatch.chdir(REPO)
    rng = np.random.default_rng(18)
    obj = "0600-plane-box"
    demo = tmp_path / "data" / "demo"
    cap = synthetic.raw_capture(str(demo / obj), obj, rng, n_annotate=20,
                                n_test=3)
    sp = convert.superpoint_from_jax(convert.init_superpoint_params(
        np.random.default_rng(0)))
    conf = {k: v for k, v in extract.CONFS["superpoint"]["conf"].items()
            if k != "descriptor_dim"}
    det = superpoint.extract(sp, torch.from_numpy(
        cap[f"{obj}-annotate"][1][::5, ..., None].astype(np.float32)), conf)
    sg = convert.plant_superglue(convert.init_superglue_params(
        rng, {"num_gnn_layers": 2}), det, 0.0)
    synthetic.write_checkpoints(
        str(tmp_path / "data"), sp, sg, convert.gats_spg_from_jax(
            convert.init_gats_spg_params(rng, {"num_blocks": 1})))
    demo_pipeline.main([obj, "--data-root", str(demo), "-o",
                        f"work_dir={tmp_path}", "device=cpu",
                        "print_config=False"])
    anno = (tmp_path / "data" / "sfm_model" / obj
            / "outputs_superpoint_superglue" / "anno")
    assert len(np.load(anno / "idxs.npy")) > 0
    assert (tmp_path / "runs" / "demo" / "demo" / "demo_video.mp4").exists()
