"""Device selection for the port's entry points.

Entry points (``init_params``, ``params_from_jax``, ``PagedCache``,
``ServingEngine``) run on the card unless the caller asks for the CPU:
``device=None`` means ``"cuda"``, and asking for CUDA without a card
raises instead of carrying on on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the port "
            "on the CPU (its kernels then run their plain PyTorch versions)")
    return dev
