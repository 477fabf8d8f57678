"""Shared-memory index serving (nvFM-server / mmap server equivalent).

The reference shares reference+FM-index across processes via POSIX shared
memory (``nvbio/basic/mmap.h``, ``nvFM-server.cpp``, SequenceDataMMAPServer).
The host-side equivalent here: artifacts exported as raw .npy files in a
directory and loaded with ``mmap_mode='r'`` — the OS page cache gives every
process on the host one physical copy; the device upload stays per-process
(one device copy per process and card).

Port of ``nvbio_tpu.io.server``. The export directory is the contract: for
the same ``index`` prefix it holds the same ``.npy`` file names, dtypes and
shapes and the same ``.json`` as the JAX package's, so either package's
client reads either package's export. The port's index classes hold
derived tables (the rank and SSA rows, an int64 ``count``, int64 q-gram
tables, ``mid_pos`` with -1 for empty buckets); they are exported in their
on-disk forms (``FMIndex.arrays()``, the ``.qgram.npz`` dtypes), and a load
rebuilds the derived tables through the class's ``from_arrays``, as
``FMIndex.load`` and ``QGramIndex.load`` do.
"""

from __future__ import annotations

import json
import os

import numpy as np


def _on_disk(obj) -> dict:
    """The fields of ``obj`` as the JAX package's class of the same name
    holds them after a load from its ``.npz``, in its field order."""
    from nvbio_tpu_torch.fmi.index import FMIndex
    from nvbio_tpu_torch.qgram import QGramIndex, position_dtype

    if isinstance(obj, FMIndex):
        out = obj.arrays()
        out["ftab_k"] = obj.ftab_k
        if obj.ftab_lo is not None:
            out["ftab_lo"] = obj.ftab_lo.cpu().numpy()
            out["ftab_hi"] = obj.ftab_hi.cpu().numpy()
        return out
    if isinstance(obj, QGramIndex):
        dt = position_dtype(obj.n)
        out = dict(q=obj.q, offsets=obj.offsets.cpu().numpy().astype(dt),
                   positions=obj.positions.cpu().numpy().astype(dt), n=obj.n)
        if obj.mid_pos is not None:
            mp = obj.mid_pos.cpu().numpy()
            out["mid_pos"] = np.where(mp < 0, np.iinfo(dt).max,
                                      mp).astype(dt)
        return out
    return vars(obj)


def export_shared(dirpath: str, name: str, obj) -> None:
    """Export a Reference/FMIndex/QGramIndex as mmap-able raw arrays."""
    os.makedirs(dirpath, exist_ok=True)
    meta = {"name": name, "type": type(obj).__name__, "fields": {}, "scalars": {}}
    for f, v in _on_disk(obj).items():
        if isinstance(v, np.ndarray):
            np.save(os.path.join(dirpath, f"{name}.{f}.npy"), v)
            meta["fields"][f] = f"{name}.{f}.npy"
        elif isinstance(v, (int, np.integer)):
            meta["scalars"][f] = int(v)
        elif isinstance(v, list):
            meta["scalars"][f] = v
    with open(os.path.join(dirpath, f"{name}.json"), "w") as fh:
        json.dump(meta, fh)


def _construct(cls, kwargs: dict):
    """``cls`` from exported fields: through ``cls.from_arrays`` where the
    class has derived tables to rebuild (FMIndex, QGramIndex), else its
    constructor (Reference: mmap-ed arrays, no host copy)."""
    return getattr(cls, "from_arrays", cls)(**kwargs)


def load_shared(dirpath: str, name: str, cls):
    """Load an exported object with memory-mapped arrays (zero host copies
    for a Reference; the index classes copy into host tensors)."""
    with open(os.path.join(dirpath, f"{name}.json")) as fh:
        meta = json.load(fh)
    kwargs = {}
    for f, fname in meta["fields"].items():
        kwargs[f] = np.load(os.path.join(dirpath, fname), mmap_mode="r")
    kwargs.update(meta["scalars"])
    return _construct(cls, kwargs)


# ---------------------------------------------------------------------------
# Live server process: a Unix-socket daemon owning an export directory and
# answering a tiny handshake protocol — the counterpart of nvFM-server's
# ServerMappedFile loop (``nvbio/basic/mmap.h:93-158``, ``nvFM-server.cpp``):
# the server pins the artifacts; clients handshake for metadata, then mmap
# the arrays (one physical copy host-wide via the page cache).
# ---------------------------------------------------------------------------


class FMServer:
    """Serves exported index artifacts over a Unix domain socket.

    Protocol (line-oriented): ``PING`` -> ``PONG``; ``LIST`` -> JSON array of
    names; ``GET <name>`` -> the artifact's JSON metadata (clients then
    ``load_shared`` the arrays via mmap); anything else -> ``ERR``.
    """

    def __init__(self, dirpath: str, socket_path: str):
        self.dirpath = dirpath
        self.socket_path = socket_path
        self._sock = None
        self._stop = False

    def names(self):
        return sorted(
            f[:-5] for f in os.listdir(self.dirpath) if f.endswith(".json"))

    def start(self):
        import socket

        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.bind(self.socket_path)
        self._sock.listen(8)
        self._sock.settimeout(0.2)
        return self

    def serve_forever(self):
        import socket as _socket

        while not self._stop:
            try:
                conn, _ = self._sock.accept()
            except _socket.timeout:
                continue
            except OSError:
                if self._stop:   # stop() closed the socket under accept()
                    return
                raise
            with conn:
                try:
                    req = conn.recv(4096).decode().strip()
                    conn.sendall(self._answer(req).encode())
                except OSError:
                    pass

    def _answer(self, req: str) -> str:
        if req == "PING":
            return "PONG\n"
        if req == "LIST":
            return json.dumps(self.names()) + "\n"
        if req.startswith("GET "):
            name = req[4:].strip()
            path = os.path.join(self.dirpath, f"{name}.json")
            if os.path.exists(path):
                with open(path) as fh:
                    return fh.read() + "\n"
            return "ERR not found\n"
        return "ERR bad request\n"

    def stop(self):
        self._stop = True
        if self._sock is not None:
            self._sock.close()
        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)


class FMClient:
    """Client handshake for ``FMServer`` (connects, queries, mmaps)."""

    def __init__(self, socket_path: str, dirpath: str):
        self.socket_path = socket_path
        self.dirpath = dirpath

    def _request(self, line: str) -> str:
        import socket

        with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
            s.connect(self.socket_path)
            s.sendall(line.encode())
            s.shutdown(socket.SHUT_WR)
            chunks = []
            while True:
                b = s.recv(65536)
                if not b:
                    break
                chunks.append(b)
        return b"".join(chunks).decode()

    def ping(self) -> bool:
        return self._request("PING").strip() == "PONG"

    def list(self) -> list:
        return json.loads(self._request("LIST"))

    def get(self, name: str, cls):
        meta = json.loads(self._request(f"GET {name}"))
        kwargs = {}
        for f, fname in meta["fields"].items():
            kwargs[f] = np.load(os.path.join(self.dirpath, fname),
                                mmap_mode="r")
        kwargs.update(meta["scalars"])
        return _construct(cls, kwargs)
