"""Native host ingress/egress — build and load the _guberhost C++ extension.

``load()`` returns the extension module, building it with g++ at first use,
or None when it is turned off (``GUBER_NATIVE=0``) or no toolchain is
available; callers then keep the protobuf path, as the JAX package does.
The fallback is logged once, and ``parser()`` names the parser that serves
(``/v1/debug/pipeline`` reports it). The build is one translation unit
against Python.h only — no libprotobuf, no numpy C API (buffers cross as
bytes; numpy wraps them with np.frombuffer zero-copy).

The library goes to ``build/native/`` at the root of the checkout (listed in
.gitignore), named after the hash of the source and the flags, so an edited
source builds anew and an unchanged one is reused. Nothing is built at
import. Once loaded, ``hashing.fingerprint`` takes the extension's
``fingerprint64`` (the same seeded XXH64).
"""

from __future__ import annotations

import hashlib
import importlib.util
import logging
import os
import subprocess
import sysconfig
from pathlib import Path
from typing import Optional

log = logging.getLogger("gubernator_tpu_torch.native")

_SRC = Path(__file__).resolve().parent / "guberhost.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"
CXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]
_mod = None
_tried = False


def _so_path() -> Path:
    include = sysconfig.get_paths()["include"]
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    digest = hashlib.sha256(
        _SRC.read_bytes() + " ".join(CXX_FLAGS + [include]).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"_guberhost-{digest}{suffix}"


def build(force: bool = False) -> Optional[str]:
    """Compile the extension into build/native/; returns the library path,
    or None when the compiler is missing or fails."""
    so = _so_path()
    if not force and so.is_file():
        return str(so)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".tmp{os.getpid()}")
    include = sysconfig.get_paths()["include"]
    cmd = ["g++", *CXX_FLAGS, f"-I{include}", "-o", str(tmp), str(_SRC)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as exc:
        detail = getattr(exc, "stderr", b"") or b""
        log.warning(
            "native guberhost build failed (%s): %s — serving through the "
            "protobuf parser", exc, detail.decode(errors="replace")[:500],
        )
        return None
    os.replace(tmp, so)
    return str(so)


def load():
    """The extension module, building it if needed; None if unavailable."""
    global _mod, _tried
    if _mod is not None or _tried:
        return _mod
    _tried = True
    if os.environ.get("GUBER_NATIVE", "").lower() in ("0", "false", "off"):
        log.info("GUBER_NATIVE=0: serving through the protobuf parser")
        return None
    path = build()
    if path is None:
        return None
    try:
        spec = importlib.util.spec_from_file_location(
            "gubernator_tpu_torch.native._guberhost", path
        )
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    except ImportError as exc:  # pragma: no cover - toolchain-specific
        log.warning("native guberhost import failed: %s — serving through "
                    "the protobuf parser", exc)
        return None
    from gubernator_tpu_torch import hashing

    hashing._native_fp = mod.fingerprint64
    _mod = mod
    return _mod


def parser() -> str:
    """Which ingress parser serves: "native" once the extension is loaded,
    "protobuf" when it is off or unavailable, "unloaded" before the first
    load()."""
    if _mod is not None:
        return "native"
    return "protobuf" if _tried else "unloaded"
