"""Device constants made once a device.

A frame reads its constants (the blue-noise mask, the SH band factors, a
DDGI grid's ray set) from tensors made at their first use on a device and
kept: no frame uploads one, so a captured frame (``RenderPipeline.compile``)
holds them as fixed addresses. The first use must come before a capture;
the capture's warm-up frame is one.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

_CACHE: dict = {}


def device_constant(key, make: Callable[[], np.ndarray], device) -> torch.Tensor:
    """``make()`` (a numpy array) as a tensor on ``device``, made at the
    first call for (``key``, device) and the same tensor after it. Nothing
    may write into it."""
    device = torch.device(device)
    t = _CACHE.get((key, device))
    if t is None:
        t = _CACHE[(key, device)] = torch.from_numpy(np.ascontiguousarray(make())).to(device)
    return t
