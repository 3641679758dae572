"""ctypes bindings for the port's native reader (cpp/fastq_reader.cpp).

The reader decodes one file on all its threads: an I/O thread cuts the
stream into record-aligned parts, workers encode, N-segment, tile and pack
them into rows, and the batches leave in file order (several files one after
another, in list order).  It is built with the C++ compiler on first use into
``sh_assembly_tpu_torch/cpp/build/`` (ignored by git), under a file name that
carries the hash of the source and the flags, so an edited source is rebuilt;
without a compiler the streams fall back to the pure-Python reader
(io/fastq.py), which gives the same batches.

The repo-level library (``cpp/``: the JAX package's reader and the ``.ser``
transcoder that formats/cqf_ser.py binds) is loaded by ``_load``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from dataclasses import dataclass
from typing import Iterator

import numpy as np

from ..utils.logging import log
from . import fastq as pyfastq

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_LIB_PATH = os.path.join(_REPO, "cpp", "build", "libshasm.so")
_lib = None
_tried = False


_ABI_VERSION = 3


def _build() -> bool:
    try:
        subprocess.run(
            ["make", "-C", os.path.join(_REPO, "cpp")],
            capture_output=True, check=True, timeout=120,
        )
        return True
    except Exception as e:  # toolchain missing: stay on the Python path
        log(f"[io] repo-level native library unavailable ({e})")
        return False


def _load():
    """The repo-level native library (cpp/build/libshasm.so), or None."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_LIB_PATH) and not _build():
        return None

    def open_lib():
        try:
            return ctypes.CDLL(_LIB_PATH)
        except OSError as e:
            log(f"[io] failed to load {_LIB_PATH}: {e}")
            return None

    lib = open_lib()
    if lib is None:
        return None
    # stale .so from an older checkout: rebuild once on ABI mismatch
    try:
        ver = lib.shr_abi_version()
    except AttributeError:
        ver = 1
    if ver != _ABI_VERSION:
        log(f"[io] native library ABI {ver} != {_ABI_VERSION}; rebuilding")
        try:
            os.remove(_LIB_PATH)
        except OSError:
            pass
        if not _build():
            return None
        lib = open_lib()
        if lib is None or lib.shr_abi_version() != _ABI_VERSION:
            log("[io] native library ABI still stale")
            return None
    _lib = lib
    return _lib


_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_READER_SRC = os.path.join(_PKG, "cpp", "fastq_reader.cpp")
_READER_BUILD = os.path.join(_PKG, "cpp", "build")
_CXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-shared",
              "-Wall"]
_CXX_LIBS = ["-lz", "-lpthread", "-ldl"]
_reader = None
_reader_tried = False


def _reader_path() -> str:
    """Where cpp/fastq_reader.cpp builds to: the name carries a hash of the
    source and of the flags."""
    digest = hashlib.sha1(" ".join(_CXX_FLAGS + _CXX_LIBS).encode())
    with open(_READER_SRC, "rb") as f:
        digest.update(f.read())
    return os.path.join(_READER_BUILD,
                        f"libfastq_reader-{digest.hexdigest()[:12]}.so")


def _reader_lib():
    """The port's reader library, built on first use, or None without a
    C++ compiler."""
    global _reader, _reader_tried
    if _reader is not None or _reader_tried:
        return _reader
    _reader_tried = True
    out = _reader_path()
    if not os.path.exists(out):
        os.makedirs(_READER_BUILD, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        try:
            subprocess.run(["g++", *_CXX_FLAGS, "-o", tmp, _READER_SRC,
                            *_CXX_LIBS], capture_output=True, check=True,
                           timeout=300)
        except (OSError, subprocess.SubprocessError) as e:
            log(f"[io] native reader unavailable ({e}); using Python reader")
            return None
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
    lib = ctypes.CDLL(out)
    u8p, i32p = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32)
    lib.fqr_has_bz2.restype = ctypes.c_int
    lib.fqr_has_bz2.argtypes = []
    lib.fqr_open.restype = ctypes.c_void_p
    lib.fqr_open.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int64]
    lib.fqr_next_batch.restype = ctypes.c_int
    lib.fqr_next_batch.argtypes = [
        ctypes.c_void_p, u8p, i32p, ctypes.c_int, ctypes.c_int, i32p]
    lib.fqr_next_batch_packed.restype = ctypes.c_int
    lib.fqr_next_batch_packed.argtypes = [
        ctypes.c_void_p, u8p, u8p, i32p, ctypes.c_int, ctypes.c_int, i32p]
    lib.fqr_failed.restype = ctypes.c_int
    lib.fqr_failed.argtypes = [ctypes.c_void_p]
    lib.fqr_stats.restype = None
    lib.fqr_stats.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_double)]
    lib.fqr_close.restype = None
    lib.fqr_close.argtypes = [ctypes.c_void_p]
    _reader = lib
    return _reader


def available() -> bool:
    return _reader_lib() is not None


@dataclass
class ReaderStats:
    """What one native stream reports when it ends: the parts decoded, the
    workers that decoded at least one, and the seconds the hand-off waited
    for the next part in order.  All zero on the Python fallback."""

    parts: int = 0
    workers: int = 0
    wait_s: float = 0.0


def _needs_py_fallback(lib, fmode: str, paths: list[str]) -> bool:
    """bz2 inputs stay on the Python reader only when the native library
    could not bind libbz2 at run time (the reference handles .bz2 natively
    via getFileReader, CQF_mt.h:933-957)."""
    wants_bz2 = fmode == "b" or any(p.endswith(".bz2") for p in paths)
    return wants_bz2 and lib.fqr_has_bz2() != 1


def _native_stream(lib, paths, k, B, L, n_threads, packed, part_bytes,
                   stats):
    """Batches from an open native reader; closes it when the stream ends
    or is abandoned, and fills `stats` before that."""
    arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
    h = lib.fqr_open(arr, len(paths), k, n_threads, L, int(packed),
                     part_bytes)
    if not h:
        raise RuntimeError(f"fqr_open refused k={k}, row length {L}")
    as_u8 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    as_i32 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    try:
        while True:
            lengths = np.zeros(B, dtype=np.int32)
            seed_col = np.full(B, -1, dtype=np.int32)
            if packed:
                rows = np.zeros((B, L // 4), dtype=np.uint8)
                nmask = np.zeros((B, L // 8), dtype=np.uint8)
                n = lib.fqr_next_batch_packed(h, as_u8(rows), as_u8(nmask),
                                              as_i32(lengths), B, L,
                                              as_i32(seed_col))
            else:
                rows = np.full((B, L), pyfastq._PAD, dtype=np.uint8)
                n = lib.fqr_next_batch(h, as_u8(rows), as_i32(lengths), B, L,
                                       as_i32(seed_col))
            if n < 0:
                raise RuntimeError(f"native reader refused batch ({B}, {L})")
            if n == 0:
                if lib.fqr_failed(h):
                    raise IOError("native reader failed (bad file?)")
                break
            if packed:
                yield pyfastq.PackedBatch(rows, nmask, lengths, n, seed_col)
            else:
                yield pyfastq.Batch(rows, lengths, n, seed_col)
    finally:
        if stats is not None:
            parts, workers = ctypes.c_int64(), ctypes.c_int32()
            wait_s = ctypes.c_double()
            lib.fqr_stats(h, ctypes.byref(parts), ctypes.byref(workers),
                          ctypes.byref(wait_s))
            stats.parts, stats.workers = parts.value, workers.value
            stats.wait_s = wait_s.value
        lib.fqr_close(h)


def batches_from_files(
    paths: list[str],
    k: int,
    fmode: str = "auto",
    reads_per_batch: int = 16384,
    max_read_len: int = 160,
    n_threads: int = 4,
    stats: ReaderStats | None = None,
    _part_bytes: int = 0,
) -> Iterator[pyfastq.Batch]:
    """Native batch stream; falls back to the Python reader for bzip2
    without libbz2 or a missing toolchain.  `stats`, if given, is filled
    when the stream ends; `_part_bytes` sets the part size (0: 8 MB)."""
    lib = _reader_lib()
    if lib is None or _needs_py_fallback(lib, fmode, paths):
        yield from pyfastq.batches_from_files(
            paths, k, fmode, reads_per_batch, max_read_len)
        return
    yield from _native_stream(lib, paths, k, reads_per_batch, max_read_len,
                              n_threads, False, _part_bytes, stats)


def packed_batches_from_files(
    paths: list[str],
    k: int,
    fmode: str = "auto",
    reads_per_batch: int = 16384,
    row_len: int = 160,
    n_threads: int = 4,
    stats: ReaderStats | None = None,
    _part_bytes: int = 0,
):
    """Batch stream in device transport format (fastq.PackedBatch): the
    native reader encodes + N-segments + 2-bit packs in C++; the Python
    fallback packs with packio.pack_np.  row_len must be a multiple of 8.
    `stats` and `_part_bytes` as in batches_from_files.
    """
    if row_len % 8:
        raise ValueError(f"row_len {row_len} is not a multiple of 8")
    lib = _reader_lib()
    B, L = reads_per_batch, row_len
    if lib is None or _needs_py_fallback(lib, fmode, paths):
        from ..ops import packio

        for b in pyfastq.batches_from_files(paths, k, fmode, B, L):
            p, m = packio.pack_np(b.codes)
            yield pyfastq.PackedBatch(p, m, b.lengths, b.n_rows, b.seed_col)
        return
    yield from _native_stream(lib, paths, k, B, L, n_threads, True,
                              _part_bytes, stats)
