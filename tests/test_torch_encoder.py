"""SuperPoint's encoder convolutions (ops/encoder.py) on the CPU, where the
wrapper takes its plain version: that version is the ``F.conv2d`` chain
``dense_heads`` ran before the kernel, bit for bit; dispatch is by device;
fp32 ``dense_heads`` on the CPU keeps its bits; the bf16 path never reaches
the wrapper. The kernel itself is held to the plain version on a card
(tests/test_torch_cuda.py)."""
import pytest
import torch
import torch.nn.functional as F

from onepose_tpu_torch.models import superpoint
from onepose_tpu_torch.ops import encoder
from onepose_tpu_torch.ops.stem import fused_stem


@pytest.fixture(scope="module")
def model():
    torch.manual_seed(0)
    return superpoint.SuperPoint().eval()


def _chain_before(model, x):
    """``dense_heads``' fp32 encoder as it was: ``nn.Conv2d``'s weights,
    NCHW, from the stem's NHWC output; the heads' ReLU output, NCHW."""
    x = x.permute(0, 3, 1, 2)
    for entry in superpoint.ENCODER_CHANNELS[3:]:
        if entry[0] == "pool":
            x = F.max_pool2d(x, 2)
        else:
            conv = getattr(model, entry[0])
            x = F.relu(F.conv2d(x, conv.weight, conv.bias, padding=1))
    w = torch.cat([model.convPa.weight, model.convDa.weight])
    b = torch.cat([model.convPa.bias, model.convDa.bias])
    return F.relu(F.conv2d(x, w, b, padding=1))


def _dense_heads_before(model, images):
    """fp32 ``dense_heads`` before the encoder kernel."""
    x = fused_stem(images, superpoint._hwio(model.conv1a.weight),
                   model.conv1a.bias, superpoint._hwio(model.conv1b.weight),
                   model.conv1b.bias)
    heads = _chain_before(model, x)
    logits = F.conv2d(heads[:, :256], model.convPb.weight, model.convPb.bias)
    desc = F.conv2d(heads[:, 256:], model.convDb.weight, model.convDb.bias)
    probs = torch.softmax(logits, dim=1)[:, :-1]
    desc = desc / torch.clamp(
        torch.linalg.vector_norm(desc, dim=1, keepdim=True), min=1e-12)
    return F.pixel_shuffle(probs, 8)[:, 0], desc.permute(0, 2, 3, 1)


@torch.no_grad()
def test_reference_is_the_chain_before_the_kernel(model):
    x = torch.rand(2, 16, 24, 64, generator=torch.Generator().manual_seed(1))
    got = encoder.encoder_reference(x, superpoint.encoder_layers(model))
    assert got.shape == (2, 4, 6, 512)
    assert torch.equal(got.permute(0, 3, 1, 2), _chain_before(model, x))


@torch.no_grad()
def test_encoder_dispatch_is_by_device(model):
    """A CPU tensor takes the plain version and counts no launch; a device
    with no kernel raises instead of falling back."""
    x = torch.rand(1, 8, 8, 64, generator=torch.Generator().manual_seed(2))
    layers = superpoint.encoder_layers(model)
    before = encoder.encoder_conv.launches
    assert torch.equal(encoder.encoder_conv(x, layers),
                       encoder.encoder_reference(x, layers))
    assert encoder.encoder_conv.launches == before
    with pytest.raises(ValueError, match="no kernel"):
        encoder.encoder_conv(x.to("meta"), layers)


@torch.no_grad()
def test_fp32_dense_heads_on_cpu_keep_their_bits(model):
    images = torch.rand(2, 32, 48, 1,
                        generator=torch.Generator().manual_seed(3))
    scores, desc = superpoint.dense_heads(model, images)
    scores0, desc0 = _dense_heads_before(model, images)
    assert torch.equal(scores, scores0) and torch.equal(desc, desc0)


@torch.no_grad()
def test_only_the_fp32_encoder_reaches_the_wrapper(model, monkeypatch):
    """fp32 (and a bf16 stem under an fp32 encoder) call ``encoder_conv``
    once with the seven convolutions; the bf16 encoder runs them through
    ``F.conv2d``, as before."""
    calls, convs = [], []
    real_wrapper, real_conv2d = superpoint.encoder_conv, F.conv2d
    monkeypatch.setattr(superpoint, "encoder_conv", lambda x, layers: (
        calls.append(len(layers)), real_wrapper(x, layers))[1])
    monkeypatch.setattr(F, "conv2d", lambda *a, **k: (
        convs.append(a[1].shape[-1]), real_conv2d(*a, **k))[1])
    images = torch.rand(1, 16, 16, 1,
                        generator=torch.Generator().manual_seed(4))
    superpoint.dense_heads(model, images)
    superpoint.dense_heads(model, images, stem_dtype="bfloat16")
    assert calls == [7, 7]
    convs.clear()
    superpoint.dense_heads(model, images, compute_dtype="bfloat16")
    assert calls == [7, 7]
    # conv1a, conv1b, the six encoder convs and the heads' 3x3, then the
    # two 1x1 heads
    assert convs == [3] * 9 + [1, 1]
