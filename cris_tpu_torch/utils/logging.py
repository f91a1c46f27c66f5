"""Logging, training meters and the experiment tracker on the standard
library's ``logging`` (counterpart of ``setup_logger``, ``log_exceptions``,
``AverageMeter``, ``ProgressMeter`` and ``ExperimentTracker`` in
cris_tpu/utils/logging.py)."""

from __future__ import annotations

import functools
import logging
import os
import sys
from typing import Dict, List, Optional

_LOG_FORMAT = "%(asctime)s | %(levelname)-8s | %(name)s:%(lineno)d - %(message)s"
_DATE_FORMAT = "%Y-%m-%d %H:%M:%S"

logger = logging.getLogger("cris_tpu_torch")


def setup_logger(save_dir: Optional[str] = None, process_index: int = 0,
                 filename: str = "log.txt", mode: str = "a") -> logging.Logger:
    """The package logger at INFO: stderr, and ``save_dir/filename`` when
    given (``mode="o"`` starts the file anew), on process 0; other
    processes stay silent."""
    for handler in logger.handlers:
        handler.close()
    logger.handlers.clear()
    logger.setLevel(logging.INFO)
    logger.propagate = False
    if process_index != 0:
        logger.addHandler(logging.NullHandler())
        return logger
    formatter = logging.Formatter(_LOG_FORMAT, datefmt=_DATE_FORMAT)
    stream = logging.StreamHandler(sys.stderr)
    stream.setFormatter(formatter)
    logger.addHandler(stream)
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        path = os.path.join(save_dir, filename)
        if mode == "o" and os.path.exists(path):
            os.remove(path)
        fh = logging.FileHandler(path, mode="a")
        fh.setFormatter(formatter)
        logger.addHandler(fh)
    return logger


def log_exceptions(fn):
    """Log an uncaught exception through the package logger, then raise
    it again (the reference's ``@logger.catch`` on its entry points)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except Exception:
            logger.exception(f"uncaught exception in {fn.__name__}")
            raise

    return wrapper


class AverageMeter:
    """Current value, running sum and mean of a scalar metric."""

    def __init__(self, name: str, fmt: str = ":f"):
        self.name = name
        self.fmt = fmt
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)

    def __str__(self):
        if self.name == "Lr":
            return ("{name}={val" + self.fmt + "}").format(**self.__dict__)
        return ("{name}={val" + self.fmt + "} ({avg" + self.fmt + "})").format(
            **self.__dict__)


class ProgressMeter:
    """Formats a batch counter and a list of meters into one log line."""

    def __init__(self, num_batches: int, meters: List[AverageMeter],
                 prefix: str = ""):
        digits = len(str(num_batches))
        self._fmt = "[{:" + str(digits) + "d}/" + f"{num_batches}]"
        self.meters = meters
        self.prefix = prefix

    def line(self, batch: int) -> str:
        return "  ".join([self.prefix + self._fmt.format(batch)]
                         + [str(m) for m in self.meters])

    def display(self, batch: int):
        logger.info(self.line(batch))


class ExperimentTracker:
    """An optional wandb metric sink: a no-op when ``enabled`` is false or
    wandb cannot be imported or started (cris_tpu/utils/logging.py:116-136)."""

    def __init__(self, enabled: bool = True, **init_kwargs):
        self._run = None
        if not enabled:
            return
        try:
            import wandb

            self._run = wandb.init(**init_kwargs)
        except Exception:  # not installed, or no login / network
            logger.warning("wandb unavailable: experiment tracking is off")
            self._run = None

    def log(self, metrics: Dict[str, float], step: Optional[int] = None):
        if self._run is not None:
            self._run.log(metrics, step=step)

    def finish(self):
        if self._run is not None:
            self._run.finish()
