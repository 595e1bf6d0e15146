"""Logging setup (counterpart of ``bmcnet_esr_tpu/utils/logging.py``, the
reference ``logger/logger.py``): console plus a rotating ``info.txt``."""

from __future__ import annotations

import logging
import logging.handlers
import os
from typing import Optional


def setup_logging(
    log_dir: Optional[str] = None,
    console_level: int = logging.DEBUG,
    file_level: int = logging.INFO,
    max_bytes: int = 10 * 1024 * 1024,
    backup_count: int = 20,
) -> None:
    root = logging.getLogger()
    root.setLevel(logging.DEBUG)
    # idempotent: drop the handlers of an earlier setup (a stale rotating
    # file handler would write into a removed run directory)
    for h in list(root.handlers):
        root.removeHandler(h)
        try:
            h.close()
        except Exception:
            pass
    console = logging.StreamHandler()
    console.setLevel(console_level)
    console.setFormatter(logging.Formatter("%(message)s"))
    root.addHandler(console)
    for noisy in ("matplotlib", "h5py", "PIL", "tensorflow"):
        logging.getLogger(noisy).setLevel(logging.WARNING)
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
        fh = logging.handlers.RotatingFileHandler(
            os.path.join(log_dir, "info.txt"), maxBytes=max_bytes, backupCount=backup_count
        )
        fh.setLevel(file_level)
        fh.setFormatter(logging.Formatter("%(asctime)s - %(name)s - %(levelname)s - %(message)s"))
        root.addHandler(fh)


def get_logger(name: str, verbosity: int = logging.DEBUG) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(verbosity)
    return logger
