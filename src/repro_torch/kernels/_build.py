"""Build the CUDA sources under ``csrc/`` into shared libraries at first use.

Each source compiles with ``nvcc`` into its own library with a plain C
interface, loaded with ``ctypes``.  A library's file name carries a hash of
its source, of the headers it includes (``#include "..."``, followed
transitively) and of the flags, so an edited source or header rebuilds the
libraries that include it and no other.  Libraries go to
``build/repro_torch_kernels/`` at the repository root (listed in
``.gitignore``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
#: every kernel source of the package
SOURCES = ("distance_topk.cu", "distance_topk_q8.cu", "flash_attention.cu",
           "flash_attention_bwd.cu")

_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
#: libraries this process has built or loaded (``load`` calls that found
#: theirs not yet loaded)
_LOADS = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def includes(source: str, csrc: Path = CSRC) -> list[str]:
    """The local headers ``source`` includes, directly or through another
    header, sorted by name."""
    seen: set[str] = set()
    todo = [source]
    while todo:
        for name in _INCLUDE.findall((csrc / todo.pop()).read_text()):
            if name not in seen:
                seen.add(name)
                todo.append(name)
    return sorted(seen)


def library_path(source: str, csrc: Path = CSRC) -> Path:
    src = csrc / source
    h = hashlib.sha256(src.read_bytes())
    for header in includes(source, csrc):
        h.update(header.encode() + (csrc / header).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}_{digest}.so"


def build_all(sources=SOURCES) -> dict[str, str]:
    """Compile every source whose library is missing, one ``nvcc`` per
    source, all started together.  Returns ``{source: compiler output}``
    for the sources it compiled (``-Xptxas -v`` register and shared-memory
    report included); raises if any compile failed."""
    procs = {}
    for source in sources:
        out = library_path(source)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
        procs[source] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            ),
            tmp,
            out,
        )
    logs, failed = {}, []
    for source, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[source] = log
        if proc.returncode != 0:
            failed.append(source)
            continue
        os.replace(tmp, out)  # atomic publish
    if failed:
        detail = "\n".join(f"--- {s}\n{logs[s]}" for s in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{detail}")
    return logs


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if missing."""
    global _LOADS
    with _LOCK:
        lib = _LIBS.get(source)
        if lib is None:
            build_all((source,))
            lib = ctypes.CDLL(str(library_path(source)))
            _LIBS[source] = lib
            _LOADS += 1
        return lib


def load_count() -> int:
    """How many kernel libraries this process has built or loaded: the
    first-use stall that ``analysis.sentinels.RetraceSentinel`` watches
    for on warmed serving traffic."""
    with _LOCK:
        return _LOADS
