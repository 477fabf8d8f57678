"""`nvbio_tpu_torch serve` — live shared-index server (nvFM-server equivalent).

Reference: ``nvFM-server/nvFM-server.cpp`` + ``nvbio/basic/mmap.h:93-158``
(ServerMappedFile): a daemon pins reference/index artifacts and serves them
to client processes; here via export-dir + Unix-socket handshake + mmap.

Port of ``nvbio_tpu/apps/server_app.py`` (host only): for the same
``index`` prefix it exports the files ``nvbio_tpu serve`` writes.
"""

from __future__ import annotations

# the server of a run in this process, while it serves: its ``stop()``,
# called from another thread, ends ``serve_forever`` and the run
current = None


def add_parser(sub):
    p = sub.add_parser("serve", help="serve index artifacts to other processes")
    p.add_argument("prefix", help="index prefix (from `index`)")
    p.add_argument("--dir", default=None,
                   help="export directory (default <prefix>.shared)")
    p.add_argument("--socket", default=None,
                   help="unix socket path (default <dir>/fm.sock)")
    p.set_defaults(func=run)
    return p


def run(args):
    global current
    import os

    from nvbio_tpu_torch.io.reference import Reference
    from nvbio_tpu_torch.io.server import FMServer, export_shared
    from nvbio_tpu_torch.utils.console import log_info

    dirpath = args.dir or (args.prefix + ".shared")
    sock = args.socket or os.path.join(dirpath, "fm.sock")

    ref = Reference.load(args.prefix + ".ref.npz")
    export_shared(dirpath, "reference", ref)
    for suffix, modcls in (
        (".qgram.npz", ("nvbio_tpu_torch.qgram", "QGramIndex")),
        (".fmi.npz", ("nvbio_tpu_torch.fmi.index", "FMIndex")),
    ):
        path = args.prefix + suffix
        if os.path.exists(path):
            import importlib

            cls = getattr(importlib.import_module(modcls[0]), modcls[1])
            export_shared(dirpath, modcls[1].lower(), cls.load(path))
    server = current = FMServer(dirpath, sock).start()
    log_info(f"serving {server.names()} on {sock} (ctrl-C to stop)")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
        current = None
    return 0
