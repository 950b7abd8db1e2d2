"""Device choice for the port's entry points: the card unless asked otherwise."""

import torch


def resolve_device(device=None):
    """torch.device for ``device``, CUDA by default. Raises when CUDA is asked
    for (or defaulted to) and no CUDA device exists: nothing falls back to the
    CPU unless the caller passes ``device="cpu"``."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return device
