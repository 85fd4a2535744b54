"""Device selection: the port runs on the card unless the caller names another
device. There is no silent fallback to the CPU: without a card, the default
raises, and CPU runs (the tests) pass ``device="cpu"`` explicitly."""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """`None` means "cuda". A CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU"
        )
    return dev


# (kernel, device index, stream) -> int32 zeros
_SCRATCH: Dict[Tuple[str, Optional[int], int], torch.Tensor] = {}


def stream_scratch(kernel: str, device: torch.device, n: int) -> torch.Tensor:
    """At least `n` int32 scratch words of `kernel` for launches on the
    current stream of `device`: allocated zeroed once (and again, larger,
    only when a launch needs more than they hold), to be left zeroed by
    every launch that uses them, so a launch adds no memset. Launches on
    one stream run in order; another stream gets its own words."""
    stream = torch.cuda.current_stream(device).cuda_stream
    key = (kernel, device.index, stream)
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < n:
        size = n if buf is None else max(n, 2 * buf.numel())
        buf = torch.zeros(size, dtype=torch.int32, device=device)
        _SCRATCH[key] = buf
    return buf


def scratch_buffers() -> list:
    """Every scratch buffer alive now: a CUDA graph that captured launches
    using them holds these, so their memory is never handed to another
    tensor while the graph can replay."""
    return list(_SCRATCH.values())
