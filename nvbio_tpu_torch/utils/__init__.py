"""Utilities: synthetic genomes and reads for tests and checks, option
files, host timers, leveled logging and alignment statistics."""

from nvbio_tpu_torch.utils.console import (  # noqa: F401
    log_debug,
    log_error,
    log_info,
    log_stats,
    log_verbose,
    log_visible,
    set_verbosity,
)
from nvbio_tpu_torch.utils.timers import Timer  # noqa: F401
