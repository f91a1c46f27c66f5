"""Reference-format LMDB shard reader (the port's copy of
cris_tpu/data/lmdb_backend.py; ``lmdb`` is an optional dependency, imported
only when a shard is opened).

Reads the LMDB layout of the reference's tools/folder2lmdb.py (keys '0',
'1', ... plus __keys__ / __len__). The released writer serialises with
pickle protocol 5, while the released reader calls the long-removed
``pyarrow.deserialize``; this reader tries pickle first and falls back to
pyarrow's legacy API where it is installed.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict


def _loads(buf: bytes) -> Any:
    try:
        return pickle.loads(buf)
    except Exception:
        import pyarrow as pa  # legacy shards serialised by pa.serialize

        return pa.deserialize(buf)


class LmdbBackend:
    """Lazy-opening LMDB reader (an environment handle is not safe to share
    across a fork or between threads)."""

    def __init__(self, lmdb_dir: str):
        import lmdb  # noqa: F401  (fail fast if missing)

        self.lmdb_dir = lmdb_dir
        self._env = None
        self._keys = None
        self._len = None

    def _ensure_open(self):
        if self._env is not None:
            return
        import lmdb

        self._env = lmdb.open(
            self.lmdb_dir,
            subdir=os.path.isdir(self.lmdb_dir),
            readonly=True,
            lock=False,
            readahead=False,
            meminit=False,
        )
        with self._env.begin(write=False) as txn:
            self._len = _loads(txn.get(b"__len__"))
            self._keys = _loads(txn.get(b"__keys__"))

    def __len__(self) -> int:
        if self._len is None:
            self._ensure_open()
        return self._len

    def __getitem__(self, index: int) -> Dict[str, Any]:
        self._ensure_open()
        with self._env.begin(write=False) as txn:
            buf = txn.get(self._keys[index])
        return _loads(buf)
