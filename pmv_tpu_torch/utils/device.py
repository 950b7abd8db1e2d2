"""Device choice for the port's entry points (the card unless asked
otherwise), and the process's place in a ``torch.distributed`` job."""

import torch
import torch.distributed as dist


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


def local_device(local_rank, device_type="cuda"):
    """The device of the process of ``local_rank`` on its host: ``cuda:<local
    rank>``, or the CPU for ``device_type`` "cpu". Raises when the host has
    no such card: two processes never share one by wrapping around."""
    if device_type == "cpu":
        return torch.device("cpu")
    resolve_device(device_type)
    if local_rank >= torch.cuda.device_count():
        raise RuntimeError(
            f"local rank {local_rank} needs cuda:{local_rank}, and this host has "
            f"{torch.cuda.device_count()} CUDA device(s): lower NUM_GPUS"
        )
    return torch.device("cuda", local_rank)


def rank_and_world_size():
    """(rank, world size) of ``torch.distributed``, or (0, 1) when it is not
    initialised."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1
