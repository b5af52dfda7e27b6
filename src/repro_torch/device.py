"""Where the port runs: on the card unless the caller asks for the CPU."""
from __future__ import annotations

import torch


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    """``None`` means the CUDA card; any other value is taken as given.

    Raises when the card is asked for (explicitly or by default) and this
    host has none — there is no silent fallback to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        hint = (" (entry points run on the card unless the caller passes "
                "device='cpu')") if device is None else ""
        raise RuntimeError(f"no CUDA device is available{hint}")
    return dev
