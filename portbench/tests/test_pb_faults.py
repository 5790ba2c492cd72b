"""A run with the timed path broken underneath must read ``correct``
false, once for each fault an inference cell can have: an answer altered
where it is produced, half of the batch left out (the rest repeated in
its place), and a step that returns its input unchanged. (The exchange
between chips does not exist on one chip.) The harness's look for a card
is skipped: the cells run on the CPU at a small size, with their own
limits. A sound run of the same size reads ``correct`` true."""
from __future__ import annotations

import pytest
import torch

from portbench.run import run_cell
from portbench.tests.small import small_work


def _alter_pose(monkeypatch):
    from onepose_tpu_torch.ops import epnp

    real = epnp.ransac_pnp

    def broken(*args, **kwargs):
        out = real(*args, **kwargs)
        pose = out.pose.clone()
        pose[0, 0, 3] += 1e-3          # one frame's pose moved by 1 mm
        return out._replace(pose=pose)

    monkeypatch.setattr(epnp, "ransac_pnp", broken)


def _half_batch(monkeypatch):
    from onepose_tpu_torch.models import superpoint

    real = superpoint.extract

    def broken(model, images, config=None):
        half = real(model, images[: (images.shape[0] + 1) // 2], config)
        return type(half)(*(torch.cat([x, x])[: images.shape[0]]
                            for x in half))

    monkeypatch.setattr(superpoint, "extract", broken)


def _gnn_unchanged(monkeypatch):
    from onepose_tpu_torch.models import gats_spg

    def broken(model, data, cfg, token_group=None):
        return (gats_spg._unit(data["descriptors2d_query"]),
                gats_spg._unit(data["descriptors3d_db"]))

    monkeypatch.setattr(gats_spg, "gnn_body", broken)


def _alter_box(monkeypatch):
    from onepose_tpu_torch.ops import similarity

    real = similarity.ransac_similarity

    def broken(*args, **kwargs):
        out = real(*args, **kwargs)
        return out._replace(t=out.t + 0.5)      # every box moved by 0.5 px

    monkeypatch.setattr(similarity, "ransac_similarity", broken)


def _half_views(monkeypatch):
    from onepose_tpu_torch.models import superglue

    real = superglue.log_assignment

    def broken(model, data, cfg):
        v = data["keypoints0"].shape[0]
        half = {k: (x[: (v + 1) // 2] if torch.is_tensor(x) else x)
                for k, x in data.items()}
        Z = real(model, half, cfg)
        return torch.cat([Z, Z])[:v]

    monkeypatch.setattr(superglue, "log_assignment", broken)


def _sinkhorn_unchanged(monkeypatch):
    from onepose_tpu_torch.models import superglue

    real = superglue.log_optimal_transport

    def broken(scores, alpha, iters):
        return real(scores, alpha, 0)

    monkeypatch.setattr(superglue, "log_optimal_transport", broken)


FAULTS = {
    "pose-fp32-b128": [_alter_pose, _half_batch, _gnn_unchanged],
    "detect-fp32-15views": [_alter_box, _half_views, _sinkhorn_unchanged],
}


@pytest.mark.parametrize("name,fault", [(n, f) for n, fs in FAULTS.items()
                                        for f in fs],
                         ids=lambda x: getattr(x, "__name__", x))
def test_fault_reads_incorrect(monkeypatch, name, fault):
    fault(monkeypatch)
    result = run_cell(small_work(name), 2 ** 32 + 11, 0.5, False, "cpu")
    assert result["correct"] is False, result["check"]


@pytest.mark.parametrize("name", list(FAULTS))
def test_sound_run_reads_correct(name):
    result = run_cell(small_work(name), 2 ** 32 + 11, 0.5, False, "cpu")
    assert result["correct"] is True, result["check"]
