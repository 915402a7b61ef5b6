"""MinHash sketches + LSH banding: the cross-layer near-duplicate index.

The counterpart of ``kraken_tpu/ops/minhash.py`` (BASELINE.json config 5).
Each Docker layer is represented by the *set* of its content-defined chunk
fingerprints (from :mod:`kraken_tpu_torch.ops.cdc` + the SHA-256 plane);
near-duplicate layers are found by MinHash similarity search so the origin
can dedup storage and preheat caches.

Math: for a random hash h, P[min_h(A) == min_h(B)] = Jaccard(A, B). A
K-coordinate sketch estimates Jaccard with stderr ~ 1/sqrt(K). Sketching
evaluates K universal hashes h_k(x) = a_k * x + b_k (mod 2^32, a_k odd)
over every fingerprint and min-reduces them, batched over layers, on the
hasher's device; large brute-force scans score there too. Candidate
retrieval uses classic LSH banding on the host (dict buckets or sorted
numpy arrays). The JAX package's three XLA functions (``_sketch_kernel``,
``_score_kernel``, ``_topk_kernel``) are plain PyTorch here.

Words are carried in ``int64`` (PyTorch's ``uint32`` has no arithmetic on
the CPU), so the sketch's min is the unsigned min of the JAX package, and
``a * x`` is taken in 16-bit halves of ``a`` so no product overflows.
Sketches are bit-identical to the JAX package's for the same seed.

Fingerprints are uint32 (first 4 bytes of each chunk's SHA-256). At 1M
chunks per corpus the birthday collision count (~100) is noise at MinHash's
estimation accuracy.
"""

from __future__ import annotations

from typing import Hashable, Sequence

import numpy as np
import torch

from kraken_tpu_torch.ops import next_pow2 as _next_pow2
from kraken_tpu_torch.ops import resolve_device

MASK = 0xFFFFFFFF
# Elements of the [B, M, K] hash intermediate per sketch step: bounds the
# device working set of a large batch.
_SKETCH_ELEMENTS = 1 << 24


def fingerprints_from_digests(digests: np.ndarray) -> np.ndarray:
    """[N, 32] uint8 chunk digests -> [N] uint32 fingerprints (deduped)."""
    if digests.size == 0:
        return np.empty(0, dtype=np.uint32)
    fp = np.ascontiguousarray(digests[:, :4]).view(">u4").reshape(-1)
    return np.unique(fp.astype(np.uint32))


def _sketch(
    fps: torch.Tensor, valid: torch.Tensor, a: torch.Tensor, b: torch.Tensor
) -> torch.Tensor:
    """fps [B, M] int64 (values < 2^32), valid [B, M] bool, a/b [K] int64
    -> [B, K] int64: min over the valid slots of a_k * x + b_k (mod 2^32);
    an empty row is all 0xFFFFFFFF. Runs over M in steps of at most
    ``_SKETCH_ELEMENTS`` hash values."""
    n_b, m = fps.shape
    k = a.numel()
    out = torch.full((n_b, k), MASK, dtype=torch.int64, device=fps.device)
    a_lo, a_hi = a & 0xFFFF, a >> 16
    step = max(1, _SKETCH_ELEMENTS // max(1, n_b * k))
    for j in range(0, m, step):
        x = fps[:, j : j + step, None]
        h = (x * a_lo + (((x * a_hi) & 0xFFFF) << 16) + b) & MASK
        h = torch.where(valid[:, j : j + step, None], h, MASK)
        out = torch.minimum(out, h.amin(dim=1))
    return out


def _to_device(rows: np.ndarray, device: torch.device) -> torch.Tensor:
    """[N, K] uint32 sketches -> int32 bit patterns on ``device`` (equality
    is all the scans ask of them)."""
    return torch.from_numpy(np.ascontiguousarray(rows).view(np.int32)).to(device)


def _device_scores(query: np.ndarray, corpus: torch.Tensor) -> torch.Tensor:
    """query [K] uint32 vs corpus [N, K] int32 on the device -> [N] float32
    estimated Jaccard."""
    q = _to_device(query[None, :], corpus.device)
    return (corpus == q).to(torch.float32).mean(dim=1)


def _topk(
    query: np.ndarray, corpus: torch.Tensor, k: int
) -> tuple[list[float], list[int]]:
    """Score + device-side top-k: only 2k scalars leave the device. Ties
    keep the lower row first, as ``jax.lax.top_k`` does."""
    top = torch.sort(_device_scores(query, corpus), descending=True, stable=True)
    return top.values[:k].tolist(), top.indices[:k].tolist()


_SCORE_DEVICE_MIN = 4096


def _score(query: np.ndarray, corpus: np.ndarray, device: torch.device) -> np.ndarray:
    """Estimated Jaccard of ``query`` vs each corpus row.

    Small candidate sets (the LSH query path: typically tens of rows)
    score on host -- a device round trip costs more than the compare
    itself. Large scans (the brute-force oracle path) go to ``device``."""
    n = corpus.shape[0]
    if n < _SCORE_DEVICE_MIN:
        return np.mean(corpus == query[None, :], axis=1, dtype=np.float32)
    return _device_scores(query, _to_device(corpus, device)).cpu().numpy()


class MinHasher:
    """K-coordinate MinHash sketcher with deterministic seeded hash params.

    ``device``: where sketches are computed (``None``: the card, which
    raises without CUDA; ``"cpu"``: plain PyTorch on the host)."""

    def __init__(
        self,
        num_hashes: int = 128,
        seed: int = 0,
        device: str | torch.device | None = None,
    ):
        if num_hashes <= 0:
            raise ValueError("num_hashes must be positive")
        self.device = resolve_device(device, "MinHasher")
        self.num_hashes = num_hashes
        rng = np.random.default_rng(seed)
        self._a = (rng.integers(0, 1 << 32, size=num_hashes, dtype=np.uint64) | 1).astype(
            np.uint32
        )
        self._b = rng.integers(0, 1 << 32, size=num_hashes, dtype=np.uint64).astype(
            np.uint32
        )
        self._a_dev = torch.from_numpy(self._a.astype(np.int64)).to(self.device)
        self._b_dev = torch.from_numpy(self._b.astype(np.int64)).to(self.device)

    def sketch(self, fingerprints: np.ndarray) -> np.ndarray:
        """[M] uint32 -> [K] uint32 sketch. Empty set -> all-0xFFFFFFFF."""
        return self.sketch_batch([fingerprints])[0]

    def sketch_batch(self, sets: Sequence[np.ndarray]) -> np.ndarray:
        """Sketch a batch of fingerprint sets -> [B, K] uint32. Sets are
        padded to the longest with masked slots."""
        if not sets:
            return np.empty((0, self.num_hashes), dtype=np.uint32)
        m = max(len(s) for s in sets)
        fps = np.zeros((len(sets), m), dtype=np.int64)
        valid = np.zeros((len(sets), m), dtype=bool)
        for i, s in enumerate(sets):
            fps[i, : len(s)] = np.asarray(s, dtype=np.uint32)
            valid[i, : len(s)] = True
        out = _sketch(
            torch.from_numpy(fps).to(self.device),
            torch.from_numpy(valid).to(self.device),
            self._a_dev, self._b_dev,
        )
        return out.cpu().numpy().astype(np.uint32)


def estimate_jaccard(sketch_a: np.ndarray, sketch_b: np.ndarray) -> float:
    """Fraction of matching coordinates ~ Jaccard(A, B)."""
    return float(np.mean(sketch_a == sketch_b))


class LSHIndex:
    """Banded LSH over MinHash sketches: O(1)-ish candidate retrieval.

    ``num_bands`` bands of ``K / num_bands`` rows; two sets collide in a
    band with probability J^rows, so the S-curve threshold sits near
    (1/num_bands)^(1/rows). Defaults (128 hashes, 32 bands, 4 rows) put the
    knee around J ~ 0.42.

    **Low-J tier**: the primary banding's
    knee leaves below-knee similarity (J in [0.2, 0.42)) nearly invisible
    -- planted retrieval @ J=0.3 measured 0.27 at 1M sets. A second tier
    of ``low_j_bands`` 2-row bands over the sketch's leading hashes
    collides with probability 1-(1-J^2)^bands (~0.95 @ J=0.3 with 32
    bands), pulling the combined S-curve's foot down to ~J=0.2 for a
    bounded cost: candidate volume grows by the corpus's background-J
    mass (scored vectorized anyway) and the band plane grows by
    12 B/set/band. ``low_j_bands=0`` restores the single-tier shape.
    """

    def __init__(
        self,
        hasher: MinHasher,
        num_bands: int = 32,
        low_j_bands: int | None = None,
    ):
        if hasher.num_hashes % num_bands:
            raise ValueError(
                f"num_bands {num_bands} must divide num_hashes {hasher.num_hashes}"
            )
        if low_j_bands is None:  # as many 2-row bands as the sketch allows
            low_j_bands = min(32, hasher.num_hashes // 2)
        if low_j_bands < 0:
            raise ValueError(f"low_j_bands must be >= 0: {low_j_bands}")
        if low_j_bands * 2 > hasher.num_hashes:
            raise ValueError(
                f"low_j_bands {low_j_bands} needs {low_j_bands * 2} hashes, "
                f"sketch has {hasher.num_hashes}"
            )
        self.hasher = hasher
        self.num_bands = num_bands
        self.low_j_bands = low_j_bands
        self.rows = hasher.num_hashes // num_bands
        total = num_bands + low_j_bands
        self._buckets: list[dict[bytes, list[int]]] = [{} for _ in range(total)]
        self._keys: list[Hashable] = []
        self._sketches: list[np.ndarray] = []
        self._key_idx: dict[Hashable, int] = {}  # live key -> row (latest wins)
        self._removed: set[int] = set()  # tombstoned row indices
        self._corpus: np.ndarray | None = None  # rebuilt lazily on query
        # Device-resident copy of the LIVE rows for brute scans: uploading
        # the corpus per query costs more than the scan (it is O(N*K)
        # bytes). Keyed by a mutation generation so consecutive queries
        # share one upload even under churn (tombstones included).
        self._gen = 0
        self._corpus_dev = None
        self._dev_gen = -1

    def __len__(self) -> int:
        return len(self._keys) - len(self._removed)

    def __contains__(self, key: Hashable) -> bool:
        """True when ``key`` is live (added and not removed/evicted)."""
        idx = self._key_idx.get(key)
        return idx is not None and idx not in self._removed

    def _band_key(self, sketch: np.ndarray, band: int) -> bytes:
        """Bucket key for global band index ``band``: primary bands slice
        ``rows`` hashes; low-J tier bands (index >= num_bands) slice 2
        hashes from the sketch's leading coordinates."""
        if band < self.num_bands:
            return sketch[band * self.rows : (band + 1) * self.rows].tobytes()
        j = band - self.num_bands
        return sketch[j * 2 : (j + 1) * 2].tobytes()

    def add(self, key: Hashable, sketch: np.ndarray) -> None:
        if key in self._key_idx:
            # Re-adding replaces: tombstone the old row, or it would stay
            # live in the band buckets forever (unremovable ghost).
            self.remove(key)
        idx = len(self._keys)
        self._keys.append(key)
        self._sketches.append(np.asarray(sketch, dtype=np.uint32))
        self._key_idx[key] = idx
        self._corpus = None
        self._gen += 1
        for band, bucket in enumerate(self._buckets):
            sig = self._band_key(self._sketches[idx], band)
            bucket.setdefault(sig, []).append(idx)

    def remove(self, key: Hashable) -> bool:
        """Tombstone ``key``: its row leaves every band bucket (so it can
        never be a candidate again); the corpus slot is reclaimed by
        :meth:`_compact` once tombstones dominate, so a churn workload
        (add+delete cycles) stays O(live), not O(ever-added). Returns False
        if ``key`` is not present."""
        idx = self._key_idx.pop(key, None)
        if idx is None:
            return False
        self._removed.add(idx)
        self._gen += 1  # live-row set changed: device cache is stale
        sketch = self._sketches[idx]
        for band, bucket in enumerate(self._buckets):
            sig = self._band_key(sketch, band)
            rows = bucket.get(sig)
            if rows is not None:
                try:
                    rows.remove(idx)
                except ValueError:
                    pass
                if not rows:
                    del bucket[sig]
        if len(self._removed) > 64 and len(self._removed) * 2 > len(self._keys):
            self._compact()
        return True

    def _compact(self) -> None:
        """Rebuild rows/buckets without tombstones (amortized O(1)/remove)."""
        live = [i for i in range(len(self._keys)) if i not in self._removed]
        keys = [self._keys[i] for i in live]
        sketches = [self._sketches[i] for i in live]
        self._keys, self._sketches = keys, sketches
        self._removed = set()
        self._key_idx = {k: i for i, k in enumerate(keys)}
        self._corpus = None
        self._gen += 1
        self._buckets = [
            {} for _ in range(self.num_bands + self.low_j_bands)
        ]
        for idx, sketch in enumerate(sketches):
            for band, bucket in enumerate(self._buckets):
                sig = self._band_key(sketch, band)
                bucket.setdefault(sig, []).append(idx)

    def candidates(self, sketch: np.ndarray) -> set[int]:
        """Indices sharing at least one band signature with ``sketch``."""
        sketch = np.asarray(sketch, dtype=np.uint32)
        out: set[int] = set()
        for band, bucket in enumerate(self._buckets):
            sig = self._band_key(sketch, band)
            out.update(bucket.get(sig, ()))
        return out

    def query(
        self, sketch: np.ndarray, k: int = 10, min_jaccard: float = 0.0
    ) -> list[tuple[Hashable, float]]:
        """Top-k (key, estimated Jaccard) among LSH candidates."""
        cand = sorted(self.candidates(sketch))
        if not cand:
            return []
        if self._corpus is None:
            self._corpus = np.stack(self._sketches)
        scores = _score(
            np.asarray(sketch, dtype=np.uint32), self._corpus[cand],
            self.hasher.device,
        )
        order = np.argsort(-scores)[:k]
        return [
            (self._keys[cand[i]], float(scores[i]))
            for i in order
            if scores[i] >= min_jaccard
        ]

    def query_brute(
        self, sketch: np.ndarray, k: int = 10
    ) -> list[tuple[Hashable, float]]:
        """Top-k against the *entire* corpus (no LSH) -- one [N, K] device op.

        Exact over sketches; used when recall matters more than latency and
        as the oracle for LSH recall tests.
        """
        live = [i for i in range(len(self._keys)) if i not in self._removed]
        if not live:
            return []
        if self._corpus is None:
            self._corpus = np.stack(self._sketches)
        query = np.asarray(sketch, dtype=np.uint32)
        if len(live) >= _SCORE_DEVICE_MIN:
            # Large corpus: scan the cached device copy of the live rows
            # (rebuilt only when the index mutated since the last scan).
            if self._corpus_dev is None or self._dev_gen != self._gen:
                rows = (
                    self._corpus
                    if len(live) == len(self._keys)
                    else self._corpus[live]
                )
                self._corpus_dev = _to_device(rows, self.hasher.device)
                self._dev_gen = self._gen
            top_v, top_i = _topk(query, self._corpus_dev, min(k, len(live)))
            return [(self._keys[live[i]], v) for i, v in zip(top_i, top_v)]
        scores = _score(query, self._corpus[live], self.hasher.device)
        order = np.argsort(-scores)[:k]
        return [(self._keys[live[i]], float(scores[i])) for i in order]


def _band_sigs(sketches: np.ndarray, num_bands: int) -> np.ndarray:
    """[N, K] uint32 sketches -> [N, B] uint64 band signatures (FNV-1a
    over each band's rows, vectorized). 64-bit sigs at 1M rows/band give
    ~3e-8 expected accidental collisions -- noise next to LSH's own
    false-candidate rate -- at half the memory of raw 16-byte keys."""
    n, k = sketches.shape
    rows = k // num_bands
    v = sketches.reshape(n, num_bands, rows).astype(np.uint64)
    h = np.full((n, num_bands), 0xCBF29CE484222325, dtype=np.uint64)
    prime = np.uint64(0x100000001B3)
    for r in range(rows):
        h = (h ^ v[:, :, r]) * prime
    return h


class BudgetExceeded(Exception):
    pass


class CompactLSHIndex:
    """Array-backed LSH index for million-set corpora, with a byte budget.

    Same banding math and the same query semantics as :class:`LSHIndex`,
    different storage (that class spends multiple KB/set in per-band dict
    buckets at 1M sets; this one ~1 KB/set all-in):

    - sketches live in ONE growable ``[cap, K]`` uint32 matrix -- no
      per-row Python objects (512 B/set at K=128);
    - each band keeps (sorted uint64 sigs, parallel int32 rows) numpy
      pairs plus an unsorted pending tail; the tail merges in when it
      outgrows ``max(4096, merged/8)``, so lookups are two binary
      searches + a small linear scan, amortized O(N log N) to build;
      12 B/set/band x 32 bands = 384 B/set for the band plane;
    - ``budget_bytes`` caps the accounted footprint; when an add would
      exceed it the OLDEST live rows are evicted (layer churn means old
      sketches are the least likely to be queried) and storage compacted.

    Tombstoned/evicted rows are dropped at merge/compact; ``remove`` and
    re-``add`` share :class:`LSHIndex` semantics (latest add wins).
    """

    def __init__(
        self,
        hasher: MinHasher,
        num_bands: int = 32,
        budget_bytes: int | None = None,
        low_j_bands: int | None = None,
    ):
        if hasher.num_hashes % num_bands:
            raise ValueError(
                f"num_bands {num_bands} must divide num_hashes {hasher.num_hashes}"
            )
        if low_j_bands is None:  # as many 2-row bands as the sketch allows
            low_j_bands = min(32, hasher.num_hashes // 2)
        if low_j_bands < 0:
            raise ValueError(f"low_j_bands must be >= 0: {low_j_bands}")
        if low_j_bands * 2 > hasher.num_hashes:
            raise ValueError(
                f"low_j_bands {low_j_bands} needs {low_j_bands * 2} hashes, "
                f"sketch has {hasher.num_hashes}"
            )
        self.hasher = hasher
        self.num_bands = num_bands
        # Low-J tier: 2-row bands over the leading hashes (see LSHIndex
        # docstring). Band storage below is sized num_bands + low_j_bands;
        # primary bands come first in every per-band array.
        self.low_j_bands = low_j_bands
        self.rows = hasher.num_hashes // num_bands
        self.budget_bytes = budget_bytes
        self.evictions = 0
        total = num_bands + low_j_bands
        self._total_bands = total
        k = hasher.num_hashes
        self._mat = np.empty((1024, k), dtype=np.uint32)
        self._n = 0  # rows used in _mat (live + dead)
        self._alive = np.zeros(1024, dtype=bool)
        self._keys: list[Hashable] = []
        self._key_idx: dict[Hashable, int] = {}
        self._dead = 0
        # Per band: merged (sorted sigs, rows) + pending (unsorted numpy
        # tail, filled to _pend_n). Pending is numpy so the per-query
        # equality scan is SIMD, not a Python loop.
        self._merged: list[tuple[np.ndarray, np.ndarray]] = [
            (np.empty(0, np.uint64), np.empty(0, np.int32))
            for _ in range(total)
        ]
        self._pend_sigs: list[np.ndarray] = [
            np.empty(4096, np.uint64) for _ in range(total)
        ]
        self._pend_rows: list[np.ndarray] = [
            np.empty(4096, np.int32) for _ in range(total)
        ]
        self._pend_n = [0] * total
        # Device-resident live rows for brute scans (see LSHIndex).
        self._gen = 0
        self._dev = None
        self._dev_live: np.ndarray | None = None
        self._dev_gen = -1

    def _all_sigs(self, sketches: np.ndarray) -> np.ndarray:
        """[N, K] sketches -> [N, num_bands + low_j_bands] uint64 sigs
        (primary tier first, then the low-J tier)."""
        sigs = _band_sigs(sketches, self.num_bands)
        if self.low_j_bands:
            lo = _band_sigs(
                sketches[:, : self.low_j_bands * 2], self.low_j_bands
            )
            sigs = np.concatenate([sigs, lo], axis=1)
        return sigs

    def __len__(self) -> int:
        return self._n - self._dead

    def __contains__(self, key: Hashable) -> bool:
        """True when ``key`` is live (added and not removed/evicted)."""
        idx = self._key_idx.get(key)
        return idx is not None and bool(self._alive[idx])

    def set_budget(self, budget_bytes: int | None) -> None:
        """Swap the byte budget live and enforce it NOW, evicting oldest
        live rows if the current footprint exceeds it. The forced-eviction
        bench path (bench_minhash.py) and the natural
        hook for a future live reload of ``dedup_budget_bytes``."""
        self.budget_bytes = budget_bytes
        if budget_bytes is not None:
            self._enforce_budget()

    # -- storage -----------------------------------------------------------

    def footprint_bytes(self) -> int:
        """Accounted index footprint: the numpy storage exactly, plus a
        ~100 B/key allowance for the Python key list + key->row dict."""
        b = self._mat.nbytes + self._alive.nbytes
        for sigs, rows in self._merged:
            b += sigs.nbytes + rows.nbytes
        for p in self._pend_sigs:
            b += p.nbytes
        for p in self._pend_rows:
            b += p.nbytes
        b += len(self._keys) * 100
        return b

    def _grow(self, need: int) -> None:
        cap = self._mat.shape[0]
        if self._n + need <= cap:
            return
        new_cap = cap
        while new_cap < self._n + need:
            new_cap *= 2
        self._mat = np.concatenate(
            [self._mat, np.empty((new_cap - cap, self._mat.shape[1]),
                                 dtype=np.uint32)]
        )
        self._alive = np.concatenate(
            [self._alive, np.zeros(new_cap - cap, dtype=bool)]
        )

    # Pending tails merge when full. The cap trades amortized merge-sort
    # work against the per-query linear scan of the tail; 64k keeps both
    # small (a 1M-row band re-sorts ~15 times; a query scans <= 64k u64
    # per band, SIMD).
    _PEND_MAX = 65536

    def _pend_cap(self, band: int) -> int:
        return min(
            self._PEND_MAX, max(4096, len(self._merged[band][0]) // 8)
        )

    def _merge_band(self, band: int) -> None:
        n = self._pend_n[band]
        sigs, rows = self._merged[band]
        all_s = np.concatenate([sigs, self._pend_sigs[band][:n]])
        all_r = np.concatenate([rows, self._pend_rows[band][:n]])
        live = self._alive[all_r]  # drop tombstones while we're here
        all_s, all_r = all_s[live], all_r[live]
        order = np.argsort(all_s, kind="stable")
        self._merged[band] = (all_s[order], all_r[order])
        self._pend_n[band] = 0

    def flush(self) -> None:
        """Merge every pending tail. Bulk-load-then-query workloads call
        this once after loading so queries are pure binary search."""
        for band in range(self._total_bands):
            if self._pend_n[band]:
                self._merge_band(band)

    # -- mutation ----------------------------------------------------------

    def add(self, key: Hashable, sketch: np.ndarray) -> None:
        self.add_batch([key], np.asarray(sketch, dtype=np.uint32)[None, :])

    def add_batch(self, keys: Sequence[Hashable], sketches: np.ndarray) -> None:
        """Bulk add: one signature pass + one pending append per band.
        Keys must be unique within the batch (duplicates across batches
        follow re-add semantics: latest wins)."""
        sketches = np.asarray(sketches, dtype=np.uint32)
        if sketches.ndim != 2 or sketches.shape[0] != len(keys):
            raise ValueError("sketches must be [len(keys), K]")
        for key in keys:
            old = self._key_idx.pop(key, None)
            if old is not None and self._alive[old]:
                self._alive[old] = False
                self._dead += 1
        n = len(keys)
        self._grow(n)
        start = self._n
        self._mat[start : start + n] = sketches
        self._alive[start : start + n] = True
        self._n += n
        for i, key in enumerate(keys):
            self._keys.append(key)
            self._key_idx[key] = start + i
        self._gen += 1  # live-row set changed: device cache is stale
        sigs = self._all_sigs(sketches)
        new_rows = np.arange(start, start + n, dtype=np.int32)
        for band in range(self._total_bands):
            self._pend_append(band, sigs[:, band], new_rows)
            if self._pend_n[band] >= self._pend_cap(band):
                self._merge_band(band)
        if self.budget_bytes is not None:
            self._enforce_budget()
        elif self._dead > 64 and self._dead * 2 > self._n:
            self._compact()

    def _pend_append(
        self, band: int, sigs: np.ndarray, rows: np.ndarray
    ) -> None:
        need = self._pend_n[band] + len(sigs)
        buf_s = self._pend_sigs[band]
        if need > len(buf_s):
            cap = max(need, 2 * len(buf_s))
            ns = np.empty(cap, np.uint64)
            nr = np.empty(cap, np.int32)
            ns[: self._pend_n[band]] = buf_s[: self._pend_n[band]]
            nr[: self._pend_n[band]] = self._pend_rows[band][
                : self._pend_n[band]
            ]
            self._pend_sigs[band], self._pend_rows[band] = ns, nr
        self._pend_sigs[band][self._pend_n[band] : need] = sigs
        self._pend_rows[band][self._pend_n[band] : need] = rows
        self._pend_n[band] = need

    def remove(self, key: Hashable) -> bool:
        idx = self._key_idx.pop(key, None)
        if idx is None or not self._alive[idx]:
            return False
        self._alive[idx] = False
        self._dead += 1
        self._gen += 1
        if self._dead > 64 and self._dead * 2 > self._n:
            self._compact()
        return True

    def _compact(self, extra_evict: int = 0) -> None:
        """Rebuild matrix + bands from live rows (oldest ``extra_evict``
        live rows dropped first -- the budget eviction path)."""
        live_rows = np.flatnonzero(self._alive[: self._n])
        if extra_evict:
            evicted = live_rows[:extra_evict]
            self._alive[evicted] = False
            self.evictions += len(evicted)
            live_rows = live_rows[extra_evict:]
        mat = self._mat[live_rows].copy()
        keys = [self._keys[i] for i in live_rows]
        k = self.hasher.num_hashes
        self._n = len(keys)
        cap = max(1024, _next_pow2(self._n))
        self._mat = np.empty((cap, k), dtype=np.uint32)
        self._mat[: self._n] = mat
        self._alive = np.zeros(cap, dtype=bool)
        self._alive[: self._n] = True
        self._keys = keys
        self._key_idx = {key: i for i, key in enumerate(keys)}
        self._dead = 0
        self._gen += 1
        self._merged = [
            (np.empty(0, np.uint64), np.empty(0, np.int32))
            for _ in range(self._total_bands)
        ]
        self._pend_sigs = [
            np.empty(4096, np.uint64) for _ in range(self._total_bands)
        ]
        self._pend_rows = [
            np.empty(4096, np.int32) for _ in range(self._total_bands)
        ]
        self._pend_n = [0] * self._total_bands
        if self._n:
            sigs = self._all_sigs(self._mat[: self._n])
            rows = np.arange(self._n, dtype=np.int32)
            for band in range(self._total_bands):
                order = np.argsort(sigs[:, band], kind="stable")
                self._merged[band] = (sigs[order, band], rows[order])

    def _enforce_budget(self) -> None:
        if self.footprint_bytes() <= self.budget_bytes:
            return
        # Evict oldest live rows, at least 10% of the corpus per pass
        # (avoids thrashing a compaction per add).
        self._compact()  # drop dead rows first; they are free savings
        while self.footprint_bytes() > self.budget_bytes:
            if not len(self):
                # Budget below the empty-index floor (preallocated matrix
                # + pending buffers): no eviction can satisfy it -- a
                # misconfiguration that must be loud, not a silently
                # always-empty index.
                raise BudgetExceeded(
                    f"budget {self.budget_bytes} B is below the empty-"
                    f"index floor ({self.footprint_bytes()} B)"
                )
            self._compact(extra_evict=max(1, len(self) // 10))

    # -- query -------------------------------------------------------------

    def candidates(self, sketch: np.ndarray) -> set[int]:
        """LIVE row indices sharing >= 1 band signature with ``sketch``."""
        sketch = np.asarray(sketch, dtype=np.uint32)
        sigs = self._all_sigs(sketch[None, :])[0]
        out: set[int] = set()
        for band in range(self._total_bands):
            target = sigs[band]
            merged_s, merged_r = self._merged[band]
            lo = np.searchsorted(merged_s, target, side="left")
            hi = np.searchsorted(merged_s, target, side="right")
            if hi > lo:
                out.update(merged_r[lo:hi].tolist())
            n_p = self._pend_n[band]
            if n_p:
                hits = np.flatnonzero(self._pend_sigs[band][:n_p] == target)
                if hits.size:
                    out.update(self._pend_rows[band][hits].tolist())
        return {i for i in out if self._alive[i]}

    def query(
        self, sketch: np.ndarray, k: int = 10, min_jaccard: float = 0.0
    ) -> list[tuple[Hashable, float]]:
        cand = sorted(self.candidates(sketch))
        if not cand:
            return []
        scores = _score(
            np.asarray(sketch, dtype=np.uint32), self._mat[cand],
            self.hasher.device,
        )
        order = np.argsort(-scores)[:k]
        return [
            (self._keys[cand[i]], float(scores[i]))
            for i in order
            if scores[i] >= min_jaccard
        ]

    def query_brute(
        self, sketch: np.ndarray, k: int = 10
    ) -> list[tuple[Hashable, float]]:
        """Top-k over every live row (oracle path; one [N, K] device op
        for large corpora)."""
        if not len(self):
            return []
        query = np.asarray(sketch, dtype=np.uint32)
        if len(self) >= _SCORE_DEVICE_MIN:
            if self._dev is None or self._dev_gen != self._gen:
                self._dev_live = np.flatnonzero(self._alive[: self._n])
                self._dev = _to_device(
                    self._mat[self._dev_live], self.hasher.device
                )
                self._dev_gen = self._gen
            live = self._dev_live
            top_v, top_i = _topk(query, self._dev, min(k, len(live)))
            return [(self._keys[live[i]], v) for i, v in zip(top_i, top_v)]
        live = np.flatnonzero(self._alive[: self._n])
        scores = _score(query, self._mat[live], self.hasher.device)
        order = np.argsort(-scores)[:k]
        return [(self._keys[live[i]], float(scores[i])) for i in order]
