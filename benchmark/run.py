"""Run one cell of the benchmark of ``nvbio_tpu_torch``.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the CUDA card(s) the cell
asks for. Prints the checks on standard error and, as the last line of
standard output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics``, ``device`` (and with ``--trace 1`` the ``breakdown``). The
cell, its configuration, traffic mix, limits and metric readers are found
by name from ``BENCHMARK.json`` (``harness/spec.py``).
"""

import os
import sys
import time

T_START = time.time()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT

from benchmark.harness.runner import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], ROOT, T_START))
