"""Device resolution: the port runs on CUDA unless the caller asks for the CPU.

There is no silent fallback. ``"cuda"`` without a usable GPU raises, so a
run that was meant for the card never continues on the host.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Map a device name to a ``torch.device``.

    Accepts ``"cuda"`` (or ``"cuda:N"``), ``"cpu"``, and the config's
    ``"auto"``, which means CUDA. Raises ``RuntimeError`` for CUDA when
    no GPU is available and ``ValueError`` for any other name.
    """
    dev = torch.device("cuda" if str(device) == "auto" else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run on the host"
            )
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {device!r}: use cuda or cpu")
