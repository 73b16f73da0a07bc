"""Where the port runs: the card unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means ``cuda``; only an explicit ``"cpu"`` gives the CPU.

    Raises ``RuntimeError`` when a CUDA device is asked for (explicitly or by
    default) and none is available: the port never drops to the CPU on its
    own, so a run without a card cannot pass for a run on one.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the port "
            "through its plain PyTorch versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"the port runs on 'cuda' or 'cpu', got {dev}")
    return dev
