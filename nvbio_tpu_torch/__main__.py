"""CLI dispatcher: ``python -m nvbio_tpu_torch <command> ...``."""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="nvbio_tpu_torch",
        description="PyTorch/CUDA port of nvbio_tpu (indexing, read "
                    "mapping, MEM alignment, read-set BWTs, error "
                    "correction, SAM/BAM sorting and diffing, read "
                    "extraction, index serving, local assembly)",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    from nvbio_tpu_torch.apps import (
        aln_diff_app,
        assemble_app,
        correct_app,
        extract_app,
        index_app,
        map_app,
        mem_app,
        server_app,
        setbwt_app,
        sort_app,
    )

    apps = {"index": index_app, "map": map_app, "mem": mem_app,
            "aln-diff": aln_diff_app, "assemble": assemble_app,
            "correct": correct_app, "extract": extract_app,
            "serve": server_app, "setbwt": setbwt_app, "sort": sort_app}
    for app in apps.values():
        app.add_parser(sub)

    args = parser.parse_args(sys.argv[1:] if argv is None else list(argv))
    try:
        return args.func(args)
    except BrokenPipeError:
        return 0  # downstream pipe (head, etc.) closed early


if __name__ == "__main__":
    sys.exit(main())
