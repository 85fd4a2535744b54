"""gubernator_tpu_torch — the rate limiter ported to PyTorch and CUDA.

A second package beside the JAX reference (``gubernator_tpu``), module for
module: ``ops/table2.py``, ``ops/kernel2.py``, ``ops/engine.py`` and the rest
keep their counterparts' names and are held to them bit for bit — responses,
stats and raw table bytes. It imports torch and never JAX; every TPU kernel
on its path is a kernel written by hand for Hopper (``csrc/``), built at
first use, never at import.

Entry points run on the card: ``LocalEngine(device=None)`` means "cuda" and
raises without one. Pass ``device="cpu"`` to run on the CPU, where each
kernel's wrapper takes its plain PyTorch version.
"""

from gubernator_tpu_torch.types import (
    Algorithm,
    Behavior,
    RateLimitRequest,
    RateLimitResponse,
    Status,
    has_behavior,
)

__version__ = "0.1.0"

__all__ = [
    "Algorithm",
    "Behavior",
    "Status",
    "RateLimitRequest",
    "RateLimitResponse",
    "has_behavior",
    "__version__",
]
