"""The device every tensor of a fit lives on."""

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``: the port's entry points run on the card
    unless the caller asks for the CPU with ``device="cpu"``.

    A CUDA device (asked for, or the default) on a machine without one
    raises: a fit never runs on the CPU instead of the card.
    """
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} was asked for (None means 'cuda'), but "
            "torch finds no CUDA device; pass device='cpu' to run on the CPU"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}")
    return device
