"""ctypes binding for the native blosc1/LZ4 codec (``data/native/blosc.cc``;
port of climate2weather_tpu/data/native_blosc.py and native_build.py).

The zarr store (``data/zarr_store.py``) reads and writes blosc chunks
through it: the external zarr default ``Blosc(cname='lz4', clevel=5,
shuffle=SHUFFLE)``, and ``write_zarr(..., compressor="blosc-lz4")``. The
HDF5 reader (``io/hdf5.py``) decodes the chunks of h5py's lzf filter with
:func:`lzf_decompress` and those of the szip filter with
:func:`szip_decompress` (``data/native/szip.cc``, in the same library).

The sources are compiled at first use by the host C++ compiler (``$CXX``,
else ``c++``, ``g++`` or ``clang++`` on PATH) into one library in
``build/`` beside the package (git-ignored), under a name keyed on a hash
of the sources, the flags and the compiler, so a stale library is never
loaded. A failed build raises with the compiler's output; nothing falls
back.
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
import time

import numpy as np

from climate2weather_tpu_torch.ops.build import BUILD_DIR

SOURCE = pathlib.Path(__file__).resolve().parent / "native" / "blosc.cc"
SZIP_SOURCE = SOURCE.with_name("szip.cc")  # compiled into the same library
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
ABI_VERSION = 1

_ERRORS = {
    -1: "truncated chunk",
    -2: "output capacity too small",
    -3: "unsupported codec (only lz4 and memcpy chunks are handled; "
        "blosclz/zlib/zstd chunks need a rewrite with compressor zlib "
        "or blosc-lz4)",
    -4: "bit-shuffle filter not supported (byte-shuffle only)",
    -5: "corrupt chunk",
    -6: "buffer too large for the blosc1 format (2 GiB chunk limit)",
}
_SZIP_ERRORS = {-1: "truncated stream", -2: "decoded size above the chunk's", -5: "corrupt stream",
                -7: "filter parameters out of range"}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# the last build: compiler, command, seconds and output
build_info: dict = {}


def find_cxx() -> str:
    """The host C++ compiler: ``$CXX``, then ``c++``, ``g++``, ``clang++``."""
    for name in filter(None, (os.environ.get("CXX"), "c++", "g++", "clang++")):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("no C++ compiler found ($CXX, c++, g++, clang++): the host codec "
                       "is built from data/native/blosc.cc and szip.cc at first use")


def library_path(cxx: str) -> pathlib.Path:
    sources = b"".join(p.read_bytes() for p in (SOURCE, SZIP_SOURCE))
    digest = hashlib.sha256(sources + repr((CXX_FLAGS, cxx)).encode())
    return BUILD_DIR / f"libc2wblosc-{digest.hexdigest()[:16]}.so"


def build(rebuild: bool = False) -> pathlib.Path:
    """Compile the codec unless a library of these sources, these flags and
    this compiler exists (or ``rebuild``); returns its path. Raises with the
    compiler's output on failure."""
    cxx = find_cxx()
    lib = library_path(cxx)
    if lib.exists() and not rebuild:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [cxx, *CXX_FLAGS, str(SOURCE), str(SZIP_SOURCE), "-o", tmp]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"the host codec failed to build ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)  # atomic: a reader never sees half a library
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    version = subprocess.run([cxx, "--version"], capture_output=True, text=True).stdout.splitlines()
    build_info.update(compiler=cxx, version=version[0] if version else "", command=" ".join(cmd),
                      seconds=time.perf_counter() - t0, output=proc.stdout + proc.stderr)
    return lib


def load(rebuild: bool = False) -> ctypes.CDLL:
    """The bound codec, built on first use (``rebuild``: compile anew and
    load that library)."""
    global _lib
    with _lock:
        if _lib is None or rebuild:
            lib = ctypes.CDLL(str(build(rebuild)))
            u8p = ctypes.POINTER(ctypes.c_uint8)
            lib.c2w_blosc_nbytes.argtypes = [u8p, ctypes.c_int64]
            lib.c2w_blosc_nbytes.restype = ctypes.c_int64
            lib.c2w_blosc_decompress.argtypes = [u8p, ctypes.c_int64, u8p, ctypes.c_int64]
            lib.c2w_blosc_decompress.restype = ctypes.c_int64
            lib.c2w_blosc_compress.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
                                               ctypes.c_int64, u8p, ctypes.c_int64]
            lib.c2w_blosc_compress.restype = ctypes.c_int64
            lib.c2w_lzf_decompress.argtypes = [u8p, ctypes.c_int64, u8p, ctypes.c_int64]
            lib.c2w_lzf_decompress.restype = ctypes.c_int64
            lib.c2w_szip_decompress.argtypes = [u8p, ctypes.c_int64, u8p, ctypes.c_int64] + [ctypes.c_int32] * 4
            lib.c2w_szip_decompress.restype = ctypes.c_int64
            lib.c2w_blosc_abi_version.restype = ctypes.c_int64
            if lib.c2w_blosc_abi_version() != ABI_VERSION:
                raise RuntimeError(f"blosc codec ABI {lib.c2w_blosc_abi_version()}, want {ABI_VERSION}")
            _lib = lib
        return _lib


def _u8(buf: np.ndarray):
    return buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _check(rc: int, what: str) -> int:
    if rc < 0:
        raise ValueError(f"blosc {what} failed: {_ERRORS.get(rc, rc)}")
    return rc


def decompress(raw: bytes) -> bytes:
    """Decode one blosc1 chunk (lz4 or memcpy, optional byte-shuffle)."""
    lib = load()
    src = np.frombuffer(raw, np.uint8)
    nbytes = _check(lib.c2w_blosc_nbytes(_u8(src), len(raw)), "header parse")
    out = np.empty(nbytes, np.uint8)
    n = _check(lib.c2w_blosc_decompress(_u8(src), len(raw), _u8(out), nbytes), "decompress")
    if n != nbytes:
        raise ValueError(f"blosc decompress failed: {n} bytes decoded, the header gives {nbytes}")
    return out.tobytes()


def compress(raw: bytes, typesize: int, shuffle: bool = True, blocksize: int = 0) -> bytes:
    """Encode one blosc1 chunk with the lz4 codec."""
    lib = load()
    src = np.frombuffer(raw, np.uint8)
    cap = 16 + len(raw) + len(raw) // 16 + 64
    out = np.empty(cap, np.uint8)
    n = _check(lib.c2w_blosc_compress(_u8(src), len(raw), int(typesize), int(bool(shuffle)), int(blocksize),
                                      _u8(out), cap), "compress")
    return out[:n].tobytes()


def lzf_decompress(raw: bytes, nbytes: int) -> bytes:
    """Decode one LZF stream (a chunk of h5py's lzf filter) of at most
    ``nbytes`` bytes."""
    lib = load()
    src = np.frombuffer(raw, np.uint8)
    out = np.empty(max(int(nbytes), 1), np.uint8)
    n = lib.c2w_lzf_decompress(_u8(src), len(raw), _u8(out), int(nbytes))
    if n < 0:
        raise ValueError(f"lzf decompress failed: {_ERRORS.get(n, n)}")
    return out[:n].tobytes()


def szip_decompress(raw: bytes, vals, nbytes: int) -> bytes:
    """Decode one chunk of HDF5's szip filter (a 4-byte little-endian
    decoded size, then the AEC stream) by the filter's client values
    ``vals`` (options mask, pixels per block, bits per pixel, pixels per
    scanline), to at most ``nbytes`` bytes."""
    if len(vals) < 4:
        raise ValueError(f"szip decompress failed: {len(vals)} filter parameters, 4 expected")
    lib = load()
    src = np.frombuffer(raw, np.uint8)
    out = np.empty(max(int(nbytes), 1), np.uint8)
    n = lib.c2w_szip_decompress(_u8(src), len(raw), _u8(out), int(nbytes), *(int(v) for v in vals[:4]))
    if n < 0:
        raise ValueError(f"szip decompress failed: {_SZIP_ERRORS.get(n, n)}")
    return out[:n].tobytes()
