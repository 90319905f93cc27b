"""Build the package's CUDA sources into shared libraries at first use.

Each source under ``csrc/`` exposes a plain ``extern "C"`` launcher. It is
compiled by ``nvcc`` for ``sm_90a`` into ``build/`` beside this package
(listed in ``.gitignore``), under a name keyed on a hash of the source and the
flags, so a stale library is never loaded, and then opened with ``ctypes``.
No PyTorch header is compiled in: the build takes seconds, and needs neither
``ninja`` nor ``torch.utils.cpp_extension``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor

PACKAGE_DIR = pathlib.Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# every kernel source of the package
SOURCES = tuple(sorted(p.name for p in CSRC_DIR.glob("*.cu")))

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
# compiler output (ptxas register and shared-memory report) of each build
build_logs: dict[str, str] = {}


def find_nvcc() -> str:
    """``nvcc`` from ``CUDA_HOME``, then ``/usr/local/cuda/bin``, then PATH."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(pathlib.Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(pathlib.Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH): the CUDA kernels are built from source at first use"
        )
    return found


def library_path(source: str) -> pathlib.Path:
    src = CSRC_DIR / source
    digest = hashlib.sha256(src.read_bytes() + repr(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:16]}.so"


def build(source: str) -> pathlib.Path:
    """Compile ``csrc/<source>`` unless a library for this exact source
    exists; returns the library's path. Raises with the compiler's output on
    failure."""
    lib = library_path(source)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / source)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) on {source}:\n"
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, lib)  # atomic: a reader never sees half a library
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    build_logs[source] = proc.stdout + proc.stderr
    return lib


def build_all(sources) -> list:
    """Build several sources at once, one ``nvcc`` process each, all started
    together; returns their libraries' paths. Raises the first failure."""
    sources = list(sources)
    with ThreadPoolExecutor(max_workers=max(1, len(sources))) as pool:
        return list(pool.map(build, sources))


def load(source: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<source>``, built on first use."""
    with _lock:
        if source not in _loaded:
            _loaded[source] = ctypes.CDLL(str(build(source)))
        return _loaded[source]
