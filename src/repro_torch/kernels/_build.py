"""Build the CUDA sources under ``csrc/`` into shared libraries at first use.

Each source compiles with ``nvcc`` into its own library with a plain C
interface, loaded with ``ctypes``: one ``nvcc -c`` per translation unit,
all of every source started together, then one link a library.  A source
is one unit unless ``UNITS`` lists several, each with its own defines:
K1's six (k_pad, path) instances, K2's three k_pad instances and K3's two
dtypes, the longest compiles, each built alone.  A library's file name carries a hash of its source, of the headers
it includes (``#include "..."``, followed transitively), of the flags and
of its units, so an edited source or header rebuilds the libraries that
include it and no other.  Libraries go to
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
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
#: the flags of a library built in one nvcc call (the tools' variants);
#: ``build_all`` compiles its units with them but ``-shared``
NVCC_FLAGS = (
    *ARCH_FLAGS, "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
#: every kernel source of the package
SOURCES = ("distance_topk.cu", "distance_topk_q8.cu", "flash_attention.cu",
           "flash_attention_bwd.cu")
#: the translation units of a source built as several (the extra defines of
#: each); a source not listed is one unit.  K2: the C entry, and each k_pad
#: instance behind ``REPRO_K``; K1: the C entry, and each (k_pad, path)
#: instance behind ``REPRO_K`` and ``REPRO_PATH`` (the batched scan 0, the
#: small-batch scan 1).  K3: the C entry, the bfloat16 instances
#: (``REPRO_K3_BF16``) and the float32 ones (``REPRO_K3_F32``).
_K_UNITS = ((), ("-DREPRO_K=128",), ("-DREPRO_K=256",), ("-DREPRO_K=512",))
UNITS = {"distance_topk.cu": ((),) + tuple((f"-DREPRO_K={k}", f"-DREPRO_PATH={path}")
                                           for k in (128, 256, 512) for path in (0, 1)),
         "distance_topk_q8.cu": _K_UNITS,
         "flash_attention.cu": ((), ("-DREPRO_K3_BF16",), ("-DREPRO_K3_F32",))}

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
    if source in UNITS:
        h.update(repr(UNITS[source]).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}_{digest}.so"


def _run(cmd) -> subprocess.Popen:
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def build_all(sources=SOURCES) -> dict[str, str]:
    """Compile every source whose library is missing, one ``nvcc -c`` per
    translation unit, all started together, then link each library.
    Returns ``{source: compiler output}`` for the sources it compiled
    (``-Xptxas -v`` register and shared-memory report included); raises if
    any compile failed."""
    procs = {}  # source -> ([(unit process, its object)], tmp library, library)
    for source in sources:
        out = library_path(source)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        units = []
        for i, defines in enumerate(UNITS.get(source, ((),))):
            obj = tmp.with_name(f"{tmp.name}.{i}.o")
            flags = [f for f in NVCC_FLAGS if f != "-shared"]
            units.append((_run([_nvcc(), *flags, *defines, "-c", "-o", str(obj),
                                str(CSRC / source)]), obj))
        procs[source] = (units, tmp, out)
    logs, failed = {}, []
    for source, (units, tmp, out) in procs.items():
        logs[source] = "".join(proc.communicate()[0] for proc, _ in units)
        ok = all(proc.returncode == 0 for proc, _ in units)
        if ok:
            link = _run([_nvcc(), *ARCH_FLAGS, "-shared", "-o", str(tmp),
                         *(str(obj) for _, obj in units)])
            logs[source] += link.communicate()[0]
            ok = link.returncode == 0
        for _, obj in units:
            obj.unlink(missing_ok=True)
        if not ok:
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
