"""Where the port's entry points put their tensors.

The port runs on the card unless the caller asks for the CPU: a ``device``
of ``None`` means ``cuda:0``, and with no CUDA device that is an error, not
a quiet fall back to the CPU.
"""

import torch

__all__ = ["resolve_device"]


def resolve_device(device):
    """``torch.device(device)``, or ``cuda:0`` for ``None``; raises
    ``RuntimeError`` for ``None`` when no CUDA device is present."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU")
    return torch.device("cuda", 0)
