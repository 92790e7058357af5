"""Device resolution and host transfers (counterpart of the JAX package's
``utils/platform.py``, which sets up JAX's compilation cache).

CUDA is the default. The CPU runs only when the caller names it: a machine
without a card raises instead of quietly running the plain route there.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises if no card); ``"cpu"`` or ``"cuda[:k]"``
    as given, checked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain PyTorch route on the host"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev} (expected cuda or cpu)")
    return dev


def to_host(tensors: Sequence[torch.Tensor]) -> list:
    """Copy tensors to host numpy arrays with one synchronisation: every copy
    is queued into pinned memory on the current stream, then the stream is
    waited on once (the counterpart of ``jax.device_get`` over a tuple)."""
    cuda = [t for t in tensors if t.is_cuda]
    if not cuda:
        return [t.numpy() for t in tensors]
    out = []
    for t in tensors:
        if t.is_cuda:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            out.append(h)
        else:
            out.append(t)
    torch.cuda.current_stream(cuda[0].device).synchronize()
    return [np.asarray(h.numpy()) for h in out]
