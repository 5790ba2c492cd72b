"""The host runtime under every entry: the device rule, batch prefetch and
upload (``loader.py``), and the native union-find of SfM's tracks
(``native.py``)."""
import torch


def resolve_device(device, who: str) -> torch.device:
    """``device`` as a torch device. The entries default to the card and
    run on the CPU only when asked; a card that is missing raises, naming
    ``who``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: no CUDA device; pass device='cpu' "
                           "(--device cpu) to run on the CPU")
    return device
