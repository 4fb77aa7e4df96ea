"""Device resolution shared by the entry points.

Entry points take ``device="cuda"`` by default and raise when no card is
present: the port never falls back to the CPU on its own. Tests and
reference runs ask for the CPU explicitly with ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the host"
        )
    return dev
