"""Device resolution for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the card.  Asking for a card when none is present
    raises: there is no silent CPU path.  Pass ``"cpu"`` to run the
    plain PyTorch versions of the kernels on the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch path on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError("unsupported device %r (use cuda or cpu)" % device)
    return dev
