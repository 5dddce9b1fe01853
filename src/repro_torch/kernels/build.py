"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file has a plain C interface and is compiled by ``nvcc``
into its own shared library for ``sm_90a`` (Hopper), then loaded with
``ctypes``.  All sources compile at once, one ``nvcc`` process each.  The
libraries land in ``build/repro_torch_kernels/`` at the repository root,
named by a hash of the source, the shared headers and the flags, so an
edited source is rebuilt and an unchanged one is loaded as it is.  Nothing
is built at import: the first kernel launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

__all__ = ["load_kernels", "build_kernels", "SOURCES", "HEADERS", "BUILD_DIR",
           "NVCC_FLAGS"]

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("miniblock_decode.cu", "fullzip_gather.cu", "ivf_topk.cu",
           "bitunpack.cu", "miniblock_take.cu")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# the C entry point of each library: name -> argtypes
_ENTRY = {
    "miniblock_decode.cu": ("miniblock_decode_launch",
                            [_P, _P, _P, _P, _P, _P, _P,
                             _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P]),
    "fullzip_gather.cu": ("fullzip_gather_launch",
                          [_P, _P, _P, _L, _L, _I, _I, _I, _P, _I, _P]),
    "ivf_topk.cu": ("ivf_topk_launch",
                    [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                     _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P]),
    "bitunpack.cu": ("bitunpack_launch", [_P, _P, _L, _I, _I, _I, _P]),
    "miniblock_take.cu": ("miniblock_take_launch",
                          [_P, _P, _P, _P, _P, _I, _L, _I, _I, _I, _I, _I, _I, _P]),
}
# headers every source may include; a change to one rebuilds them all
HEADERS = ("device_guard.cuh",)

_lock = threading.Lock()
_loaded: Optional["Kernels"] = None


class Kernels:
    """The loaded libraries' entry points, as attributes."""

    def __init__(self, libs: Dict[str, ctypes.CDLL]):
        for src, lib in libs.items():
            name, argtypes = _ENTRY[src]
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            setattr(self, name, fn)
        self._libs = libs  # keep the handles alive


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    cand.append(shutil.which("nvcc") or "")
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(src: str) -> Path:
    h = hashlib.sha256()
    for f in (src, *HEADERS):
        h.update((CSRC / f).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{Path(src).stem}-{h.hexdigest()[:16]}.so"


def build_kernels() -> Dict[str, object]:
    """Compile every source whose library is missing, all in parallel.
    Returns ``{"seconds", "built", "ptxas"}``: wall time, the sources
    compiled, and the ptxas resource lines (registers, shared memory,
    spills) of each kernel."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in SOURCES:
        out = _lib_path(src)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs.append((src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    ptxas: List[str] = []
    failed = []
    for src, out, tmp, p in procs:
        log, _ = p.communicate()
        ptxas += [f"{src}: {ln.strip()}" for ln in log.splitlines()
                  if "registers" in ln or "spill" in ln]
        if p.returncode != 0:
            failed.append(f"{src}:\n{log}")
        else:
            os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return {"seconds": time.perf_counter() - t0,
            "built": [s for s, *_ in procs], "ptxas": ptxas}


def load_kernels() -> Kernels:
    """Build (if needed) and load the kernel libraries, once per process."""
    global _loaded
    with _lock:
        if _loaded is None:
            build_kernels()
            _loaded = Kernels({src: ctypes.CDLL(str(_lib_path(src)))
                               for src in SOURCES})
        return _loaded
