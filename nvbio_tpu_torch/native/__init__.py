"""Native (C++) host helpers, built on demand with g++ and loaded by ctypes.

A copy of ``nvbio_tpu.native``: ``qgram.cpp`` is the same counting-sort
table construction, ``bgzf.cpp`` the same multithreaded BGZF block
compressor (linked with zlib), ``sais.cpp`` the same SA-IS suffix sorter
(byte and integer alphabets), ``lz4.cpp`` the same LZ4 block codec (the
``.bwt`` LZ4 frames) and ``bwte.cpp`` the same BWTE engine (BCR block BWTs
and rank-walk merges of read sets), each compiled at first use into
``nvbio_tpu_torch/native/build/`` (gitignored, content-hash staleness).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD = os.path.join(_DIR, "build")
_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def _compile(name: str, sources: list[str], extra_flags=()) -> str:
    os.makedirs(_BUILD, exist_ok=True)
    out = os.path.join(_BUILD, f"lib{name}.so")
    srcs = [os.path.join(_DIR, s) for s in sources]
    # content-hash staleness: mtimes are unreliable across checkouts, and a
    # binary built with -march=native on another machine may SIGILL
    h = hashlib.sha256()
    for p in srcs:
        with open(p, "rb") as f:
            h.update(f.read())
    h.update(" ".join(extra_flags).encode())
    h.update(platform.machine().encode() + platform.node().encode())
    stamp = os.path.join(_BUILD, f"lib{name}.sha")
    digest = h.hexdigest()
    if os.path.exists(out) and os.path.exists(stamp):
        with open(stamp) as f:
            if f.read().strip() == digest:
                return out
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-std=c++17", "-fPIC", "-shared",
           "-o", tmp, *srcs, *extra_flags]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, out)
    with open(stamp, "w") as f:
        f.write(digest)
    return out


def load(name: str, sources: list[str], extra_flags=()) -> ctypes.CDLL:
    """Compile (if stale) and dlopen a native library."""
    with _LOCK:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(_compile(name, sources, extra_flags))
        return _LIBS[name]


def _builds(get) -> bool:
    try:
        get()
    except (OSError, subprocess.CalledProcessError):
        return False
    return True


def sais_available() -> bool:
    """Whether the native SA-IS suffix sorter builds and loads here."""
    return _builds(get_sais)


def get_sais() -> ctypes.CDLL:
    """Native SA-IS suffix sorter (int32 and int64 index engines)."""
    lib = load("nvbio_torch_sais", ["sais.cpp"])
    fn = lib.nvbio_tpu_sais_u8
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p,
    ]
    fn64 = lib.nvbio_tpu_sais_u8_64
    fn64.restype = ctypes.c_int
    fn64.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
    ]
    fi = lib.nvbio_tpu_sais_i32
    fi.restype = ctypes.c_int
    fi.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p,
    ]
    return lib


def sais_u8(codes, K: int = 4):
    """Suffix array of ``codes`` (+ implicit sentinel): int32[n+1]
    (dispatches to the int64 engine past 2^31 symbols)."""
    lib = get_sais()
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    n = len(codes)
    if n >= 2**31 - 1:
        return sais_u8_64(codes, K)
    sa = np.empty(n + 1, dtype=np.int32)
    rc = lib.nvbio_tpu_sais_u8(
        codes.ctypes.data, np.int32(n), np.int32(K), sa.ctypes.data)
    if rc != 0:
        raise RuntimeError(f"sais failed: {rc}")
    return sa


def sais_i32(codes, K: int):
    """Integer-alphabet SA-IS: suffix array int32[n+1] of an int32 text in
    [0, K) (+ implicit sentinel). Serves multi-string BCR texts with
    distinct per-string sentinels (K = n_strings + 4)."""
    lib = get_sais()
    codes = np.ascontiguousarray(codes, dtype=np.int32)
    n = len(codes)
    if n >= 2**31 - 2:
        raise ValueError("sais_i32 is 32-bit-indexed; shard the text")
    sa = np.empty(n + 1, dtype=np.int32)
    rc = lib.nvbio_tpu_sais_i32(
        codes.ctypes.data, np.int32(n), np.int32(K), sa.ctypes.data)
    if rc != 0:
        raise RuntimeError(f"sais_i32 failed: {rc}")
    return sa


def sais_u8_64(codes, K: int = 4):
    """64-bit-index SA-IS: suffix array int64[n+1] for multi-GB texts."""
    lib = get_sais()
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    n = len(codes)
    sa = np.empty(n + 1, dtype=np.int64)
    rc = lib.nvbio_tpu_sais_u8_64(
        codes.ctypes.data, np.int64(n), np.int64(K), sa.ctypes.data)
    if rc != 0:
        raise RuntimeError(f"sais64 failed: {rc}")
    return sa


def get_qgram() -> ctypes.CDLL:
    lib = load("nvbio_torch_qgram", ["qgram.cpp"])
    fn = lib.nvbio_tpu_qgram_build
    fn.restype = ctypes.c_int64
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    return lib


def qgram_available() -> bool:
    """Whether the native q-gram builder builds and loads here."""
    return _builds(get_qgram)


def qgram_build(codes, q: int, n_flags=None):
    """Counting-sort q-gram table: (offsets, positions) uint32 arrays."""
    lib = get_qgram()
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    n = len(codes)
    npos = max(n - q + 1, 0)
    offsets = np.empty((1 << (2 * q)) + 1, dtype=np.uint32)
    positions = np.empty(npos, dtype=np.uint32)
    flags_ptr = None
    if n_flags is not None:
        n_flags = np.ascontiguousarray(n_flags, dtype=np.uint8)[:n]
        if len(n_flags) < n:
            raise ValueError("n_flags shorter than codes")
        flags_ptr = n_flags.ctypes.data
    written = lib.nvbio_tpu_qgram_build(
        codes.ctypes.data, ctypes.c_int64(n), np.int32(q), flags_ptr,
        offsets.ctypes.data, positions.ctypes.data,
    )
    if written < 0:
        raise RuntimeError(f"qgram_build failed: {written}")
    return offsets, positions[:written]


def get_bgzf() -> ctypes.CDLL:
    """Native multithreaded BGZF compressor (links zlib)."""
    lib = load("nvbio_torch_bgzf", ["bgzf.cpp"], extra_flags=("-lz",
                                                              "-pthread"))
    fn = lib.nvbio_tpu_bgzf_compress
    fn.restype = ctypes.c_int64
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    mx = lib.nvbio_tpu_bgzf_max_output
    mx.restype = ctypes.c_int64
    mx.argtypes = [ctypes.c_int64]
    return lib


def bgzf_available() -> bool:
    """Whether the native BGZF compressor builds and loads here."""
    return _builds(get_bgzf)


def get_lz4() -> ctypes.CDLL:
    """Native LZ4 block codec (``lz4.cpp``)."""
    lib = load("nvbio_torch_lz4", ["lz4.cpp"])
    lib.nvb_lz4_bound.restype = ctypes.c_int64
    lib.nvb_lz4_bound.argtypes = [ctypes.c_int64]
    for name in ("nvb_lz4_compress", "nvb_lz4_decompress"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                       ctypes.c_int64]
    return lib


def _bytes_u8(data) -> np.ndarray:
    if isinstance(data, (bytes, bytearray)):
        return np.frombuffer(bytes(data), np.uint8)
    return np.ascontiguousarray(data, dtype=np.uint8)


def lz4_compress(data) -> np.ndarray:
    """LZ4 block-format compression of bytes or a uint8 array; returns a
    uint8 array."""
    src = _bytes_u8(data)
    lib = get_lz4()
    cap = int(lib.nvb_lz4_bound(len(src)))
    dst = np.empty(cap, np.uint8)
    m = lib.nvb_lz4_compress(src.ctypes.data, len(src), dst.ctypes.data, cap)
    if m < 0:
        raise ValueError("lz4 compression overflow")
    return dst[:m].copy()


def lz4_decompress(comp, raw_len: int) -> np.ndarray:
    """Inverse of ``lz4_compress``; ``raw_len`` is the original size.
    Raises ValueError on a malformed block."""
    src = _bytes_u8(comp)
    lib = get_lz4()
    dst = np.empty(max(raw_len, 1), np.uint8)
    m = lib.nvb_lz4_decompress(src.ctypes.data, len(src), dst.ctypes.data,
                               raw_len)
    if m != raw_len:
        raise ValueError(f"lz4 decompression failed ({m} != {raw_len})")
    return dst[:raw_len]


def get_bwte() -> ctypes.CDLL:
    """Native BWTE engine (``bwte.cpp``): BCR block BWTs and merges."""
    lib = load("nvbio_torch_bwte", ["bwte.cpp"])
    fn = lib.nvbio_tpu_bcr_block
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
    ]
    mg = lib.nvbio_tpu_bwte_merge
    mg.restype = ctypes.c_int
    mg.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
    ]
    return lib


def bwte_available() -> bool:
    """Whether the native BWTE engine builds and loads here."""
    return _builds(get_bwte)


def bcr_block_bwt(reads):
    """Multi-string BWT of a uniform-length read matrix (uint8[m, L] of
    0..3) by native BCR column rounds: uint8[m*(L+1)] over {0:'$',1..4}."""
    lib = get_bwte()
    reads = np.ascontiguousarray(reads, dtype=np.uint8)
    m, L = reads.shape
    out = np.empty(m * (L + 1), dtype=np.uint8)
    rc = lib.nvbio_tpu_bcr_block(
        reads.ctypes.data, ctypes.c_int64(m), ctypes.c_int64(L),
        out.ctypes.data)
    if rc != 0:
        raise RuntimeError(f"bcr_block failed: {rc}")
    return out


def bwte_merge(M, S_prev: int, reads, B):
    """Merge a block (reads uint8[m, L] and its block BWT ``B``) into the
    accumulated multi-string BWT ``M`` of ``S_prev`` strings: dual LF rank
    walks and one interleave pass. Requires len(M) + len(B) < 2^32."""
    lib = get_bwte()
    M = np.ascontiguousarray(M, dtype=np.uint8)
    B = np.ascontiguousarray(B, dtype=np.uint8)
    reads = np.ascontiguousarray(reads, dtype=np.uint8)
    m, L = reads.shape
    if len(B) != m * (L + 1):
        raise ValueError(f"block BWT of {len(B)} symbols for {m} reads of "
                         f"{L}")
    out = np.empty(len(M) + len(B), dtype=np.uint8)
    rc = lib.nvbio_tpu_bwte_merge(
        M.ctypes.data, ctypes.c_int64(len(M)), ctypes.c_int64(S_prev),
        reads.ctypes.data, ctypes.c_int64(m), ctypes.c_int64(L),
        B.ctypes.data, out.ctypes.data)
    if rc != 0:
        raise RuntimeError(f"bwte_merge failed: {rc}")
    return out
