"""Structure from motion with known poses, on one device: extraction,
pair selection, matching, triangulation, global BA and postprocess
(``runner.run_sfm`` drives them)."""
import torch


def resolve_device(device, who: str) -> torch.device:
    """``device`` as a torch device; the card unless the caller names
    another, and a card that is missing raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: no CUDA device; pass device='cpu' to "
                           "run on the CPU")
    return device
