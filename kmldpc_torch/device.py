"""Device selection: an explicit ``torch.device``, never a silent fallback."""

from __future__ import annotations

import torch


def resolve_device(name: str | torch.device = "cuda") -> torch.device:
    """Turn a device name into a ``torch.device``.

    ``"cuda"`` (or ``"cuda:N"``) raises ``RuntimeError`` when PyTorch sees
    no CUDA device; it never hands back the CPU instead.  ``"cpu"`` is the
    test path, running every kernel's plain PyTorch version.
    """
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() "
                "is False (no CUDA device or a CPU-only PyTorch build)"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(dev)!r}; use 'cuda' or 'cpu'")
    return dev
