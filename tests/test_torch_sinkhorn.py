"""SuperGlue's Sinkhorn (ops/sinkhorn.py) on the CPU, where the wrapper
takes its plain version: that version is the eager loop
``superglue.log_optimal_transport`` ran before the kernel, bit for bit,
and the CPU path never reaches the kernel library; dispatch is by device.
The JAX parity of the same loop is ``tests/test_torch_superglue.py::
test_sinkhorn_matches_jax``; the kernel is held to the plain version on a
card (tests/test_torch_cuda.py)."""
import pytest
import torch

from onepose_tpu_torch.models import superglue
from onepose_tpu_torch.ops import _kernels, sinkhorn


def _loop_before(scores, alpha, iters):
    """``superglue.log_optimal_transport`` as it was before the kernel."""
    b, m, n = scores.shape
    f32 = dict(dtype=torch.float32, device=scores.device)
    ms, ns = torch.tensor(float(m), **f32), torch.tensor(float(n), **f32)
    alpha = alpha.to(torch.float32)
    couplings = torch.cat(
        [torch.cat([scores, alpha.expand(b, m, 1)], dim=-1),
         torch.cat([alpha.expand(b, 1, n), alpha.expand(b, 1, 1)], dim=-1)],
        dim=1)
    norm = -torch.log(ms + ns)
    log_mu = torch.cat([norm.expand(m), (torch.log(ns) + norm)[None]])
    log_nu = torch.cat([norm.expand(n), (torch.log(ms) + norm)[None]])
    log_mu = log_mu.expand(b, m + 1)
    log_nu = log_nu.expand(b, n + 1)
    u = torch.zeros_like(log_mu)
    v = torch.zeros_like(log_nu)
    for _ in range(iters):
        u = log_mu - torch.logsumexp(couplings + v[:, None, :], dim=2)
        v = log_nu - torch.logsumexp(couplings + u[:, :, None], dim=1)
    return couplings + u[:, :, None] + v[:, None, :] - norm


def _scores(shape, seed):
    scores = torch.randn(shape, generator=torch.Generator().manual_seed(seed))
    scores = scores * 3
    scores[0, -3:] = -1e9          # padded rows
    scores[-1, :, -2:] = -1e9      # padded columns
    return scores


@pytest.mark.parametrize("shape,iters", [((2, 30, 37), 0), ((2, 30, 37), 1),
                                         ((3, 17, 9), 100)])
def test_cpu_path_is_the_loop_before_the_kernel(monkeypatch, shape, iters):
    """On the CPU, ``log_optimal_transport`` and ``log_sinkhorn`` give the
    old loop's bits, count no launch and never load the kernel library."""
    def no_library():
        raise AssertionError("the CPU path loaded the kernel library")

    monkeypatch.setattr(_kernels, "library", no_library)
    scores, alpha = _scores(shape, iters), torch.tensor(0.7)
    before = sinkhorn.log_sinkhorn.launches
    want = _loop_before(scores, alpha, iters)
    assert torch.equal(superglue.log_optimal_transport(scores, alpha, iters),
                       want)
    assert torch.equal(sinkhorn.log_sinkhorn(scores, alpha, iters), want)
    assert torch.equal(sinkhorn.sinkhorn_reference(scores, alpha, iters),
                       want)
    assert sinkhorn.log_sinkhorn.launches == before


def test_dispatch_is_by_device():
    """A device with no kernel raises instead of falling back."""
    scores = _scores((1, 8, 8), 0)
    with pytest.raises(ValueError, match="no kernel"):
        sinkhorn.log_sinkhorn(scores.to("meta"), torch.tensor(0.7), 5)


def test_reference_in_float64():
    """In float64 the plain version keeps float64 throughout (the card
    tests' reference); it stays within fp32 rounding of the fp32 run."""
    scores, alpha = _scores((2, 30, 37), 4), torch.tensor(0.7)
    z64 = sinkhorn.sinkhorn_reference(scores.double(), alpha.double(), 50)
    z32 = sinkhorn.sinkhorn_reference(scores, alpha, 50)
    assert z64.dtype == torch.float64
    live = z64.abs() < 1e6
    assert float((z64 - z32.double()).abs()[live].max()) < 1e-4
