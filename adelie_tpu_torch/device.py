"""The device every tensor of a fit lives on."""

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"`` when a GPU is available, else ``"cpu"``.

    An explicit CUDA device on a machine without one raises: a fit asked
    for the GPU never runs on the CPU instead.
    """
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} was asked for, but torch finds no CUDA "
            "device"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}")
    return device
