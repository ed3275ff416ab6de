"""GeneFace-format IndexedDataset binary record store, reader and writer
(port of ``moditalker_tpu/data/indexed.py``; format of
AToM/data_util/indexed_datasets.py:18-157).

A ``<path>.data`` file whose first 32 bytes hold the little-endian length of
a pickled index dict {'offsets': [...], 'id2pos': {...}, 'meta': {...}}
written at byte 32; records are pickled (optionally gzipped) blobs at
absolute ``offsets``. Multi-chunk spill files ``<path>.<k>.data`` are read
too. Byte-compatible both ways with the JAX package's writer and reader, and
so with the reference's ``train.data`` databases.
"""

from __future__ import annotations

import gzip
import pickle
from bisect import bisect


HEADER_SIZE = 32
DEFAULT_INDEX_SIZE = 1024 * 1024 * 16


class IndexedReader:
    def __init__(self, path: str, unpickle: bool = True):
        self.path = path
        self.unpickle = unpickle
        with open(f"{path}.data", "rb") as f:
            index_len = int.from_bytes(f.read(HEADER_SIZE), "little")
            index = pickle.loads(f.read(index_len))
        self.offsets = list(index["offsets"])
        self.id2pos = dict(index.get("id2pos", {}))
        self.meta = dict(index.get("meta", {}))
        self.gzip = self.meta.get("gzip", False)
        self.chunk_begin = list(self.meta.get("chunk_begin", [0]))

    def __len__(self) -> int:
        return len(self.offsets) - 1

    def _file_for(self, offset: int) -> tuple[str, int]:
        chunk_id = bisect(self.chunk_begin[1:], offset)
        name = (
            f"{self.path}.data" if chunk_id == 0 else f"{self.path}.{chunk_id}.data"
        )
        return name, offset - self.chunk_begin[chunk_id]

    def __getitem__(self, i):
        if self.id2pos:
            i = self.id2pos.get(i, i)
        if i < 0 or i >= len(self):
            raise IndexError(i)
        name, rel = self._file_for(self.offsets[i])
        with open(name, "rb") as f:
            f.seek(rel)
            blob = f.read(self.offsets[i + 1] - self.offsets[i])
        if not self.unpickle:
            return blob
        if self.gzip:
            blob = gzip.decompress(blob)
        return pickle.loads(blob)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


class IndexedWriter:
    """Single-chunk writer, format-compatible with the reference reader."""

    def __init__(self, path: str, gzip_items: bool = False,
                 index_size: int = DEFAULT_INDEX_SIZE):
        self.path = path
        self.index_size = index_size
        self.f = open(f"{path}.data", "wb")
        self.f.seek(index_size)
        self.offsets = [index_size]
        self.id2pos: dict = {}
        self.gzip = gzip_items
        self.meta = {"chunk_begin": [0], "gzip": gzip_items}

    def add_item(self, item, id=None):
        blob = pickle.dumps(item)
        if self.gzip:
            blob = gzip.compress(blob, 1)
        n = self.f.write(blob)
        if id is not None:
            self.id2pos[id] = len(self.offsets) - 1
        self.offsets.append(self.offsets[-1] + n)

    def finalize(self):
        index = pickle.dumps(
            {"offsets": self.offsets, "id2pos": self.id2pos, "meta": self.meta}
        )
        assert len(index) < self.index_size, "index overflow"
        self.f.seek(0)
        self.f.write(len(index).to_bytes(
            (len(index).bit_length() + 7) // 8 or 1, "little"))
        self.f.seek(HEADER_SIZE)
        self.f.write(index)
        self.f.close()
