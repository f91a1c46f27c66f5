"""The run's seed (counterpart of cris_tpu/utils/seed.py:17-31).

A drawn seed is broadcast from rank 0, so that every data-parallel rank
shuffles the same permutation and draws the same dropout seeds."""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..parallel import broadcast_int


def init_random_seed(seed: Optional[int] = None) -> int:
    """The configured seed, or one drawn with numpy when it is None, rank
    0's on every rank."""
    if seed is not None:
        return int(seed)
    return broadcast_int(int(np.random.randint(2**31)))
