"""BGZF blocked-gzip codec (the BAM container framing).

Counterpart of the reference's contrib bamtools/htslib BGZF layer
(``contrib/bamtools/BGZF.{h,cpp}``, used by ``io/output/output_bam.h:75-118``):
a gzip-compatible stream of independently-deflated blocks, each carrying its
compressed size in a ``BC`` extra field so readers can seek block-to-block.

Compression runs through zlib's C deflate; blocks are framed here. Writes are
safe to read back with any BGZF-aware tool (samtools, htslib, gzip).

A copy of ``nvbio_tpu.io.bgzf``, with the port's own native build.
"""

from __future__ import annotations

import struct
import subprocess
import zlib

# BGZF caps each block's *uncompressed* payload so BSIZE (u16) can't overflow.
MAX_BLOCK_PAYLOAD = 65280

_BGZF_HEADER = struct.Struct("<BBBBIBBHBBHH")  # gzip header + xlen + BC extra
_BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)


def compress_block(data: bytes, level: int = 6) -> bytes:
    """Deflate one <=64KiB payload into a complete BGZF block."""
    if len(data) > MAX_BLOCK_PAYLOAD:
        raise ValueError(f"BGZF block payload too large: {len(data)}")
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    cdata = co.compress(data) + co.flush()
    bsize = len(cdata) + 25 + 1  # header(12) + extra(6) + cdata + crc(4)+isize(4)
    header = _BGZF_HEADER.pack(
        0x1F, 0x8B, 8, 4,      # gzip magic, deflate, FEXTRA
        0, 0, 0xFF,            # mtime, xfl, os=unknown
        6,                     # XLEN
        0x42, 0x43, 2,         # 'B','C', subfield length
        bsize - 1,             # BSIZE - 1
    )
    tail = struct.pack("<II", zlib.crc32(data) & 0xFFFFFFFF, len(data))
    return header + cdata + tail


def _native_bgzf():
    from nvbio_tpu_torch.native import get_bgzf

    try:
        return get_bgzf()
    except (OSError, subprocess.CalledProcessError):
        return None  # no compiler or no zlib headers: Python zlib


class BgzfWriter:
    """BGZF writer; batches blocks through the native multithreaded
    compressor (``native/bgzf.cpp``) when available, else Python zlib."""

    # accumulate this much before handing a batch to the thread pool
    NATIVE_CHUNK = 64 * MAX_BLOCK_PAYLOAD

    def __init__(self, path_or_file, level: int = 6, threads: int | None = None):
        import os as _os

        if threads is None:
            threads = _os.cpu_count() or 1
        self._own = isinstance(path_or_file, str)
        self.f = open(path_or_file, "wb") if self._own else path_or_file
        self.level = level
        self.threads = threads
        self._buf = bytearray()
        self._lib = _native_bgzf()

    @property
    def compressor(self) -> str:
        """Which compressor writes the blocks: "native" or "python"."""
        return "python" if self._lib is None else "native"

    def _compress_out(self, data: bytes) -> None:
        if self._lib is not None and len(data) > MAX_BLOCK_PAYLOAD:
            import ctypes

            cap = self._lib.nvbio_tpu_bgzf_max_output(len(data))
            out = ctypes.create_string_buffer(cap)
            total = self._lib.nvbio_tpu_bgzf_compress(
                data, len(data), self.level, self.threads, out, None)
            if total > 0:
                self.f.write(out.raw[:total])
                return
        for i in range(0, max(len(data), 1) if data else 0,
                       MAX_BLOCK_PAYLOAD):
            self.f.write(compress_block(
                data[i:i + MAX_BLOCK_PAYLOAD], self.level))

    def write(self, data: bytes) -> None:
        self._buf += data
        if len(self._buf) >= self.NATIVE_CHUNK:
            full = len(self._buf) // MAX_BLOCK_PAYLOAD * MAX_BLOCK_PAYLOAD
            self._compress_out(bytes(self._buf[:full]))
            del self._buf[:full]

    def flush(self) -> None:
        if self._buf:
            self._compress_out(bytes(self._buf))
            self._buf.clear()
        self.f.flush()

    def close(self) -> None:
        self.flush()
        self.f.write(_BGZF_EOF)
        if self._own:
            self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class BgzfReader:
    """Streaming BGZF decompressor with a file-like ``read(n)`` interface."""

    def __init__(self, path_or_file):
        self._own = isinstance(path_or_file, str)
        self.f = open(path_or_file, "rb") if self._own else path_or_file
        self._buf = b""
        self._pos = 0
        self._eof = False

    def _next_block(self) -> bool:
        head = self.f.read(12)
        if len(head) < 12:
            self._eof = True
            return False
        if head[:4] != b"\x1f\x8b\x08\x04":
            raise ValueError("not a BGZF stream (bad block magic)")
        xlen = struct.unpack("<H", head[10:12])[0]
        extra = self.f.read(xlen)
        bsize = None
        i = 0
        while i + 4 <= len(extra):
            si1, si2, slen = extra[i], extra[i + 1], struct.unpack(
                "<H", extra[i + 2:i + 4])[0]
            if si1 == 0x42 and si2 == 0x43 and slen == 2:
                bsize = struct.unpack("<H", extra[i + 4:i + 6])[0] + 1
            i += 4 + slen
        if bsize is None:
            raise ValueError("BGZF block missing BC extra field")
        cdata = self.f.read(bsize - 12 - xlen - 8)
        crc, isize = struct.unpack("<II", self.f.read(8))
        data = zlib.decompress(cdata, -15)
        if len(data) != isize or (zlib.crc32(data) & 0xFFFFFFFF) != crc:
            raise ValueError("BGZF block checksum mismatch")
        self._buf = data
        self._pos = 0
        return True

    def read(self, n: int) -> bytes:
        out = bytearray()
        while n > 0:
            avail = len(self._buf) - self._pos
            if avail == 0:
                if self._eof or not self._next_block():
                    break
                continue
            take = min(n, avail)
            out += self._buf[self._pos:self._pos + take]
            self._pos += take
            n -= take
        return bytes(out)

    def read_all(self) -> bytes:
        chunks = [self._buf[self._pos:]]
        self._buf, self._pos = b"", 0
        while self._next_block():
            chunks.append(self._buf)
            self._buf = b""
        return b"".join(chunks)

    def close(self) -> None:
        if self._own:
            self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
