"""Training meters on the standard library's ``logging`` (counterpart of
``AverageMeter`` and ``ProgressMeter`` in cris_tpu/utils/logging.py)."""

from __future__ import annotations

import logging
from typing import List

logger = logging.getLogger("cris_tpu_torch")


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
