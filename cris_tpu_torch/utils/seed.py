"""The run's seed (counterpart of cris_tpu/utils/seed.py:17-31).

One process: the seed is not broadcast (data parallel comes later)."""

from __future__ import annotations

from typing import Optional

import numpy as np


def init_random_seed(seed: Optional[int] = None) -> int:
    """The configured seed, or one drawn with numpy when it is None."""
    if seed is not None:
        return int(seed)
    return int(np.random.randint(2**31))
