"""Build and load the port's CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` with a plain C interface, plus the
headers it includes. At first use it is compiled for Hopper with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v  <the kernel's own flags>

into ``build/kernels/`` at the root of the checkout (listed in .gitignore)
and loaded with ctypes. ``KERNELS`` names each kernel's extra flags and
headers: ``probe_walk`` builds with ``--fmad=false``, so its float64 lanes
round exactly as the CPU's do. Builds come only from the sources in this
package; a library is named after the content hash of its sources and
flags, so an edited source builds anew and an unchanged one is reused.
Nothing is built at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# per-kernel extra nvcc flags and included headers (under csrc/)
KERNELS: Dict[str, dict] = {
    "slot_write": {"flags": [], "headers": []},
    "probe_walk": {"flags": ["--fmad=false"], "headers": ["bucket_math.cuh"]},
    "fence_claim": {"flags": [], "headers": []},
    "sweep_copy": {"flags": [], "headers": ["bulk_stream.cuh"]},
    "sweep_rows": {"flags": [],
                   "headers": ["bulk_stream.cuh", "sweep_groups.cuh", "sweep_links.cuh"]},
    "sweep_slots": {"flags": [], "headers": ["sweep_links.cuh"]},
    "sweep_window": {"flags": [], "headers": ["sweep_groups.cuh", "sweep_links.cuh"]},
    "ring_exchange": {"flags": [], "headers": []},
}

# loaded libraries by kernel name (a CDLL lives as long as the process)
_LIBS: Dict[str, ctypes.CDLL] = {}
# per-kernel build records: {"seconds", "log", "path", "flags"}
BUILD_LOG: Dict[str, dict] = {}


def nvcc() -> str:
    """Path of nvcc; raises when the CUDA toolkit is not installed."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA toolkit is needed "
        "to build the port's kernels"
    )


def flags(name: str) -> List[str]:
    """The full nvcc flag list of kernel `name`."""
    return NVCC_FLAGS + KERNELS[name]["flags"]


def _lib_path(name: str) -> Path:
    blob = (CSRC / f"{name}.cu").read_bytes()
    for h in KERNELS[name]["headers"]:
        blob += (CSRC / h).read_bytes()
    digest = hashlib.sha256(blob + " ".join(flags(name)).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_all(names: Iterable[str]) -> Dict[str, dict]:
    """Compile every named kernel that is not built yet, one nvcc per
    source, all started together. Returns the build records."""
    names = list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs: List[tuple] = []
    for name in names:
        out = _lib_path(name)
        if out.is_file():
            BUILD_LOG.setdefault(name, {"seconds": 0.0, "log": "cached", "path": str(out),
                                        "flags": flags(name)})
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc(), *flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        t0 = time.perf_counter()
        p = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        procs.append((name, p, tmp, out, t0))
    failed = []
    for name, p, tmp, out, t0 in procs:
        log, _ = p.communicate()
        secs = time.perf_counter() - t0
        if p.returncode != 0:
            failed.append(f"{name}: nvcc exit {p.returncode}\n{log}")
            continue
        os.replace(tmp, out)
        BUILD_LOG[name] = {"seconds": secs, "log": log, "path": str(out),
                           "flags": flags(name)}
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return {n: BUILD_LOG[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, building it at first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        _LIBS[name] = lib
    return lib
