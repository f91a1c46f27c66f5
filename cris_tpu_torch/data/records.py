"""RefPack: one flat file of pickled records with an offset index (the
port's copy of cris_tpu/data/records.py, the same file format, so either
package reads what the other writes).

Record schema, the reference's LMDB payload:
  {img: jpeg bytes, mask: png bytes, cat: int, seg_id: int,
   img_name: str, num_sents: int, sents: [str, ...]}

File layout:
  header: magic b'RFPK' | uint32 version | uint64 count | uint64 index_off
  body:   count pickled records, back to back
  index:  (count + 1) uint64 offsets (record i spans [off[i], off[i+1]))

Records are unpickled: open only RefPack files from a trusted source.
"""

from __future__ import annotations

import mmap
import os
import pickle
import struct
from typing import Any, Dict, Iterable, List

MAGIC = b"RFPK"
VERSION = 1
_HEADER = struct.Struct("<4sIQQ")


class RefPackWriter:
    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "wb")
        self._f.write(_HEADER.pack(MAGIC, VERSION, 0, 0))
        self._offsets: List[int] = [self._f.tell()]

    def write(self, record: Dict[str, Any]):
        self._f.write(pickle.dumps(record, protocol=pickle.HIGHEST_PROTOCOL))
        self._offsets.append(self._f.tell())

    def close(self):
        index_off = self._f.tell()
        self._f.write(struct.pack(f"<{len(self._offsets)}Q", *self._offsets))
        self._f.seek(0)
        self._f.write(_HEADER.pack(MAGIC, VERSION, len(self._offsets) - 1,
                                   index_off))
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class RefPackReader:
    """Thread-safe random-access reader over an mmap'd RefPack file."""

    def __init__(self, path: str):
        self.path = path
        self._file = open(path, "rb")
        self._mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        magic, version, count, index_off = _HEADER.unpack_from(self._mm, 0)
        if magic != MAGIC:
            raise ValueError(f"{path} is not a RefPack file")
        if version != VERSION:
            raise ValueError(f"unsupported RefPack version {version}")
        self._count = count
        self._offsets = struct.unpack_from(f"<{count + 1}Q", self._mm, index_off)

    def __len__(self) -> int:
        return self._count

    def __getitem__(self, index: int) -> Dict[str, Any]:
        if not 0 <= index < self._count:
            raise IndexError(index)
        return pickle.loads(self._mm[self._offsets[index]:
                                     self._offsets[index + 1]])

    def close(self):
        self._mm.close()
        self._file.close()


def write_refpack(path: str, records: Iterable[Dict[str, Any]]) -> int:
    n = 0
    with RefPackWriter(path) as w:
        for rec in records:
            w.write(rec)
            n += 1
    return n
