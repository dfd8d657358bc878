"""Build, load and count the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared
library with a plain C interface and loaded with ``ctypes``. A library is
built on first use into ``build/kernels/`` at the repository root, under a
name keyed on a hash of its source, the shared headers (``csrc/*.cuh``)
and the compiler flags, so an edited source never loads a stale library.
``build()`` starts one ``nvcc`` per missing library, all at once, and
waits for them together.

The whole-solve libraries (``resident_pcg``, ``streamed_pcg``, ``xl_pcg``)
each export ``pe_<library>_launch_query``: the cooperative-launch
attribute of a device and their f32 kernel's occupancy at a dynamic
shared-memory size (``launch_query``); ``xl_pcg``, whose grid is its
occupancy, also ``pe_xl_pcg_<form>_launch_query`` for its other forms.

Nothing here runs at import time: the CPU tests import every module of
the port on a machine with no ``nvcc``.

Flags: ``-fmad=false`` keeps every product rounded before the sum that
uses it, so each kernel's arrays agree bitwise with its plain PyTorch
version on the same card; ``-Xptxas -v`` reports registers, shared memory
and spills, which ``build()`` returns and keeps next to the library.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

SOURCES = ("stencil", "fused_pcg", "resident_pcg", "streamed_pcg",
           "xl_pcg", "stencil_dots", "fused_sharded", "stage4")

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
    "-fmad=false", "-Xptxas", "-v",
)

# launches per kernel name, counted by the wrappers where they launch
LAUNCHES: collections.Counter = collections.Counter()

_LOADED: dict[str, ctypes.CDLL] = {}
# the symbols whose signatures have been declared, by library
_DECLARED: dict[str, set] = {}


def count_launch(kernel: str) -> None:
    LAUNCHES[kernel] += 1


def reset_launches() -> None:
    LAUNCHES.clear()


def source_path(name: str) -> Path:
    return _CSRC / f"{name}.cu"


def library_path(name: str) -> Path:
    digest = hashlib.sha256(source_path(name).read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the toolkit's
    default location, else ``nvcc`` on the PATH."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the port's CUDA kernels are "
            "built from csrc/ on the machine with the card"
        )
    return found


def build(names=SOURCES) -> dict[str, str]:
    """Build every missing library of ``names`` in parallel; return each
    library's ptxas report (registers, shared memory, spills)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(source_path(name))]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True),
            tmp, lib,
        )
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{out}")
            continue
        lib.with_suffix(".ptxas.txt").write_text(out)
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    reports = {}
    for name in names:
        report = library_path(name).with_suffix(".ptxas.txt")
        reports[name] = report.read_text() if report.exists() else ""
    return reports


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library ``name``, built first if it is missing, with
    ``signatures`` ({symbol: (restype, [argtypes])}) declared. A symbol
    is declared once: the wrappers call this on every launch, and a call
    that brings no new symbol sets nothing."""
    lib = _LOADED.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build((name,))
        lib = _LOADED[name] = ctypes.CDLL(str(path))
    declared = _DECLARED.setdefault(name, set())
    if not signatures.keys() <= declared:
        for symbol, (restype, argtypes) in signatures.items():
            if symbol not in declared:
                fn = getattr(lib, symbol)
                fn.restype = restype
                fn.argtypes = argtypes
                declared.add(symbol)
    return lib


def launch_query(name: str, device: int, smem_bytes: int,
                 form: str = "f32") -> tuple[int, int]:
    """(cooperative-launch attribute of ``device``, blocks of library
    ``name``'s whole-solve kernel in ``form`` that fit on one SM with
    ``smem_bytes`` of dynamic shared memory), from
    ``pe_<name>_launch_query`` (the f32 form) or
    ``pe_<name>_<form>_launch_query``."""
    symbol = (f"pe_{name}_launch_query" if form == "f32"
              else f"pe_{name}_{form}_launch_query")
    ptr = ctypes.POINTER(ctypes.c_int)
    lib = load(name, {
        symbol: (ctypes.c_int, [ctypes.c_int, ctypes.c_int, ptr, ptr]),
        f"pe_{name}_error_string": (ctypes.c_char_p, [ctypes.c_int]),
    })
    cooperative, per_sm = ctypes.c_int(0), ctypes.c_int(0)
    rc = getattr(lib, symbol)(device, smem_bytes, ctypes.byref(cooperative),
                              ctypes.byref(per_sm))
    check(getattr(lib, f"pe_{name}_error_string"), symbol, rc)
    return cooperative.value, per_sm.value


def check(error_string, kernel: str, rc: int) -> None:
    """Raise if a launch returned a CUDA error code; ``error_string`` is
    the library's ``const char* (int)`` message function."""
    if rc != 0:
        raise RuntimeError(
            f"{kernel}: CUDA launch failed ({rc}: {error_string(rc).decode()})"
        )


def stream_handle(device) -> int:
    """The handle of PyTorch's current stream on ``device`` (a tensor's
    CUDA device, so indexed), for a kernel launch. It is read on every
    launch, so it is read as PyTorch's own generated code reads it, with
    no ``torch.cuda.Stream`` object built around it."""
    import torch

    return torch._C._cuda_getCurrentRawStream(device.index)
