"""Device resolution and host<->device plane copies.

Port of the transfer half of ``pilosa_tpu/platform.py`` (``:171``
``h2d_copy``). There is no dispatch lock and no backend probing: PyTorch
launches are ordered on the current CUDA stream, and the caller names its
device. Planes live on the host as ``np.uint32`` and on the device as
``torch.int32`` with the same bit patterns (torch's ``uint32`` lacks
``~``, shifts and ``index_put``).
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]


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
    """uint32 host planes -> int32 device tensor (bit-identical)."""
    arr = np.ascontiguousarray(host, dtype=np.uint32).view(np.int32)
    t = torch.from_numpy(arr)
    if device.type == "cpu":
        return t.clone()  # never alias the caller's host planes
    return t.to(device)


def d2h(t: torch.Tensor) -> np.ndarray:
    """int32 device tensor -> uint32 host array (bit-identical)."""
    return t.detach().to("cpu").contiguous().numpy().view(np.uint32)
