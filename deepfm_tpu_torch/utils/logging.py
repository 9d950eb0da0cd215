"""Run logging.

Port of ``deepfm_tpu/utils/logging.py``. Behavioral contract (kept
compatible with the reference logger factory, reference:
deepfm/utils/logging.py:8-41): INFO-level lines like
``2026-01-01 12:00:00 [deepfm_tpu_torch] INFO: message`` on stdout, an
optional per-run file sink, and no duplicate emission when a child logger
(``deepfm_tpu_torch.trainer``) is fetched: the child just propagates
upward.

The stdout sink belongs to the package's logger (the name's first dotted
part), configured on the first call whichever logger it asks for, so a
child fetched before its ancestor still has its lines printed once. That
logger disables propagation: where a root handler is installed
(``logging.basicConfig``, as the CLI does), every line would otherwise
print twice. A ``log_file`` takes the place of the file an earlier call
gave the same logger, so that each of several runs in one process (the
tests, ``chip_smoke.py``) writes its own log.
"""

from __future__ import annotations

import logging
import os
import sys
from pathlib import Path

LINE_FORMAT = "%(asctime)s [%(name)s] %(levelname)s: %(message)s"
TIME_FORMAT = "%Y-%m-%d %H:%M:%S"


def _attach(logger: logging.Logger, sink: logging.Handler) -> None:
    sink.setFormatter(logging.Formatter(LINE_FORMAT, datefmt=TIME_FORMAT))
    logger.addHandler(sink)


def get_logger(name: str, log_file: str | None = None) -> logging.Logger:
    """Fetch (and on first use, configure) the named run logger; with
    ``log_file``, its lines (a child's too) also go to that file."""
    package = logging.getLogger(name.split(".")[0])
    if not package.handlers:
        package.setLevel(logging.INFO)
        _attach(package, logging.StreamHandler(sys.stdout))
        package.propagate = False
    logger = logging.getLogger(name)
    if log_file is not None:
        path = os.path.abspath(log_file)
        for sink in list(logger.handlers):
            if isinstance(sink, logging.FileHandler) \
                    and sink.baseFilename != path:
                logger.removeHandler(sink)
                sink.close()
        if not any(isinstance(sink, logging.FileHandler)
                   for sink in logger.handlers):
            Path(path).parent.mkdir(parents=True, exist_ok=True)
            _attach(logger, logging.FileHandler(path))
    return logger
