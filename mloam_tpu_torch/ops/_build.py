"""The one place that builds and loads the package's native code.

``csrc/*.cu``, the hand-written CUDA kernels, are compiled with ``nvcc`` for
``sm_90a`` into shared libraries with a plain C interface (no PyTorch
headers, so a build takes seconds) under ``mloam_tpu_torch/_build/``, at
first use, keyed by a hash of the sources, and loaded with ``ctypes``. One
``nvcc`` process per source, all started together.

``csrc/*.cpp`` is host code (the dataset reader of ``utils/dataio``: file and
packet decoding, gridding, prefetch threads). It goes the host route: the
host C++ compiler (``c++ -O3 -std=c++17 -shared -fPIC -pthread`` with its
C++ runtime linked in, ``HOST_CXX_FLAGS``), the same hashed library names
under ``_build/``, ``ctypes``. ``nvcc`` builds only the
``.cu`` sources.

A failed build raises; nothing here falls back to anything. Nothing in this
module runs at import: machines without ``nvcc`` import the package and use
the plain versions on CPU tensors.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_libs: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (looked at $NVCC, PATH and /usr/local/cuda/bin): the "
        "CUDA kernels of mloam_tpu_torch cannot be built on this machine")


# The host library is loaded into a process that has loaded many other C++
# libraries (PyTorch's, CUDA's, their JIT compilers') by the time it is first
# used; it carries its own C++ runtime, hidden from them (static libstdc++ and
# libgcc, their symbols not exported, its own symbols bound inside it), so no
# other copy of the runtime or global locale is bound to its iostreams.
HOST_CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
                  "-static-libstdc++", "-static-libgcc", "-Wl,--exclude-libs,ALL",
                  "-Wl,-Bsymbolic"]


def find_cxx() -> str:
    for cand in (os.environ.get("CXX"), shutil.which("c++"), shutil.which("g++")):
        if cand and (os.path.isfile(cand) or shutil.which(cand)):
            return cand
    raise RuntimeError(
        "no host C++ compiler found (looked at $CXX, c++ and g++ on PATH): "
        "the dataset library of mloam_tpu_torch cannot be built on this machine")


def sources() -> list[Path]:
    """The CUDA kernel sources (``nvcc``)."""
    return sorted(CSRC.glob("*.cu"))


def _lib_path(src: Path, flags=NVCC_FLAGS) -> Path:
    h = hashlib.sha256()
    h.update(" ".join(flags).encode())
    h.update(src.read_bytes())
    return BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


def build_all(verbose: bool = False) -> dict[str, Path]:
    """Build every kernel source that has no up-to-date library yet; all
    compilers run in parallel. Returns {stem: library path}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, procs = {}, []
    for src in sources():
        lib = _lib_path(src)
        out[src.stem] = lib
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [find_nvcc(), *NVCC_FLAGS]
        if verbose:
            cmd += ["-Xptxas", "-v"]
        cmd += ["-o", str(tmp), str(src)]
        procs.append((src, lib, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failures = []
    for src, lib, tmp, cmd, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            failures.append(f"{' '.join(cmd)}\n{log}")
            continue
        if verbose and log:
            print(log, flush=True)
        os.replace(tmp, lib)  # atomic publish: no half-written library is loaded
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return out


def load(stem: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu``, built first if needed."""
    lib = _libs.get(stem)
    if lib is None:
        paths = build_all()
        if stem not in paths:
            raise RuntimeError(f"no kernel source csrc/{stem}.cu")
        lib = ctypes.CDLL(str(paths[stem]))
        _libs[stem] = lib
    return lib


def load_host(stem: str) -> ctypes.CDLL:
    """The loaded library of the host source ``csrc/<stem>.cpp``, built
    first with the host C++ compiler if it has no up-to-date library."""
    key = f"host:{stem}"
    lib = _libs.get(key)
    if lib is not None:
        return lib
    src = CSRC / f"{stem}.cpp"
    if not src.is_file():
        raise RuntimeError(f"no host source csrc/{stem}.cpp")
    path = _lib_path(src, HOST_CXX_FLAGS)
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [find_cxx(), *HOST_CXX_FLAGS, "-o", str(tmp), str(src)]
        p = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True)
        if p.returncode != 0:
            raise RuntimeError(f"host C++ build failed:\n{' '.join(cmd)}\n{p.stdout}")
        os.replace(tmp, path)
    lib = ctypes.CDLL(str(path))
    _libs[key] = lib
    return lib


def check(err: int, what: str):
    """Raise if a C entry returned a CUDA error code from its launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error code {err}")
