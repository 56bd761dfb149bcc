"""Device resolution and host<->device plane copies.

Port of the transfer half of ``pilosa_tpu/platform.py`` (``:171``
``h2d_copy``, with its ``device.h2d_copy`` span and the device
profiler's h2d hook, ``:188-202``). There is no dispatch lock and no
backend probing: PyTorch launches are ordered on the current CUDA
stream, and the caller names its device. Planes live on the host as
``np.uint32`` and on the device as ``torch.int32`` with the same bit
patterns (torch's ``uint32`` lacks ``~``, shifts and ``index_put``).
"""

from __future__ import annotations

import time
from typing import Union

import numpy as np
import torch

from pilosa_tpu_torch.obs.tracing import get_tracer

DeviceLike = Union[str, torch.device, None]

# The h2d hook of the device profiler (obs/devprof.py installs it while
# the profiler is enabled; None is the fast path, where h2d_copy does no
# extra work). It receives (nbytes, seconds) of each copy.
_H2D_HOOK = None


def set_h2d_hook(hook) -> None:
    """Install (or with None, remove) the profiler's h2d callback."""
    global _H2D_HOOK
    _H2D_HOOK = hook


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the card, ``cuda:0``. Without a card that is an
    error: the port never moves to the CPU unless the caller asks for it
    with ``device="cpu"``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the port's plain PyTorch versions on the CPU")
        return torch.device("cuda", 0)
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not "
                               "available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def h2d_copy(host: np.ndarray, device: torch.device) -> torch.Tensor:
    """uint32 host planes -> int32 device tensor (bit-identical), traced
    as a ``device.h2d_copy`` span tagged with the byte count, as the JAX
    package traces it: a warm resident query has no such span."""
    arr = np.ascontiguousarray(host, dtype=np.uint32).view(np.int32)
    t = torch.from_numpy(arr)
    hook = _H2D_HOOK
    with get_tracer().start_span("device.h2d_copy", nbytes=arr.nbytes):
        t0 = time.perf_counter() if hook is not None else 0.0
        # never alias the caller's host planes on the CPU
        out = t.clone() if device.type == "cpu" else t.to(device)
    if hook is not None:
        hook(arr.nbytes, time.perf_counter() - t0)
    return out


def d2h(t: torch.Tensor) -> np.ndarray:
    """int32 device tensor -> uint32 host array (bit-identical)."""
    return t.detach().to("cpu").contiguous().numpy().view(np.uint32)
