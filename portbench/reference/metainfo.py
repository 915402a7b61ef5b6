"""What a blob's metainfo must be: its length, its piece length from the
configuration's table, and the SHA-256 of every piece."""

from __future__ import annotations

import hashlib
import os
from concurrent.futures import ThreadPoolExecutor


def piece_length(table: list[list[int]], size: int) -> int:
    """The configuration's table of (least blob size, piece length),
    read top-down; the last row that fits wins."""
    chosen = table[0][1]
    for least, plen in table:
        if size >= least:
            chosen = plen
    return chosen


def piece_hashes(data: bytes, plen: int) -> bytes:
    """SHA-256 of each piece, over threads (``hashlib`` lets go of the
    interpreter lock on large buffers)."""
    view = memoryview(data)
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as ex:
        return b"".join(ex.map(lambda o: hashlib.sha256(view[o:o + plen]).digest(),
                               range(0, len(view), plen)))


def expected(data: bytes, table: list[list[int]]) -> dict:
    plen = piece_length(table, len(data))
    return {"length": len(data), "piece_length": plen, "piece_hashes": piece_hashes(data, plen),
            "digest": hashlib.sha256(data).hexdigest()}


def metainfo_wrong(got: dict, want: dict) -> int:
    """1 when any field of a metainfo the program made differs from the
    reference's, else 0."""
    return int(any(got[k] != want[k] for k in ("digest", "length", "piece_length", "piece_hashes")))
