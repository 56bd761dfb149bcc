"""Device resolution and host<->device plane copies.

Port of the transfer half of ``pilosa_tpu/platform.py`` (``:171``
``h2d_copy``, with its ``device.h2d_copy`` span, the lock tracer's
dispatch note and the device profiler's h2d hook, ``:186-202``). There
is no dispatch lock and no
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

from pilosa_tpu_torch.analysis import locktrace
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


def staging(shape, dtype: torch.dtype, device: torch.device,
            fill: int = 0) -> torch.Tensor:
    """A host tensor to assemble an upload in: pinned when it goes to a
    card, so that :func:`h2d_copy` of it with ``non_blocking`` is one
    pinned copy."""
    return torch.full(shape, fill, dtype=dtype,
                      pin_memory=device.type == "cuda")


def h2d_copy(host: Union[np.ndarray, torch.Tensor], device: torch.device,
             non_blocking: bool = False) -> torch.Tensor:
    """Host -> device copy, traced as a ``device.h2d_copy`` span tagged
    with the byte count, as the JAX package traces it: a warm resident
    query has no such span. ``host`` is either uint32 planes, which land
    as an int32 tensor with the same bits, or a host tensor (a
    :func:`staging` buffer), copied as it is, ``non_blocking`` when
    asked. On the CPU planes are cloned (the caller's host planes are
    never aliased) and a host tensor is handed over as it is."""
    if isinstance(host, torch.Tensor):
        t, given = host, True
    else:
        arr = np.ascontiguousarray(host, dtype=np.uint32).view(np.int32)
        t, given = torch.from_numpy(arr), False
    nbytes = t.numel() * t.element_size()
    if locktrace.ACTIVE is not None:
        locktrace.ACTIVE.note_dispatch("platform.h2d_copy")
    hook = _H2D_HOOK
    with get_tracer().start_span("device.h2d_copy", nbytes=nbytes):
        t0 = time.perf_counter() if hook is not None else 0.0
        if device.type == "cpu":
            out = t if given else t.clone()
        else:
            out = t.to(device, non_blocking=non_blocking)
    if hook is not None:
        hook(nbytes, time.perf_counter() - t0)
    return out


def d2h(t: torch.Tensor) -> np.ndarray:
    """int32 device tensor -> uint32 host array (bit-identical)."""
    return t.detach().to("cpu").contiguous().numpy().view(np.uint32)
