"""PyTorch + CUDA port of the ``repro`` package for an NVIDIA H100 (sm_90a).

Mirrors the JAX package's module paths and public names.  It imports
``torch`` and never ``jax``, and nothing of ``repro``: what it needs of
the JAX package's stdlib modules it keeps as its own copies.  Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asked
    for another.  Raises when CUDA is asked for (or defaulted to) and is
    missing — an entry point never drops to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
