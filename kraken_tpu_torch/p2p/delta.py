"""Chunk-level delta transfer: pull only the bytes the cluster lacks.

The port's copy of ``kraken_tpu.p2p.delta``. It adds one counter of its
own, ``delta_stage_seconds_total``, and the same ``seconds`` on the
``delta prefill`` log line: a prefill's wall split by stage.

The dedup plane finds duplicate bytes across layers and then the wire
moves whole blobs anyway. This module cashes that in on the agent's pull
path:

1. **Plan**: fetch the target blob's :class:`~kraken_tpu_torch.core.metainfo.
   ChunkRecipe` (tracker-proxied from the origin's dedup sidecars), ask
   ``/similar`` for near-duplicate blobs, keep the candidates already in
   the local cache, and diff recipes into ``have`` spans (bytes a local
   base blob already holds) and ``need`` spans.
2. **Copy**: for every piece the base covers, copy the have-chunks out of
   the local base -- each chunk re-hashed against its recipe fingerprint
   first, so a corrupt or stale base degrades to a fetch, never into the
   assembled blob.
3. **Fetch**: pieces the base covers only partially get their need spans
   as origin byte-range GETs (the ``X-Kraken-Origin`` addr the tracker
   stamps on the recipe response); pieces with little or no coverage stay
   missing and ride the normal swarm piece pulls.

Every assembled piece goes through the UNCHANGED
:meth:`~kraken_tpu_torch.p2p.storage.Torrent.write_piece` verify (full
per-piece SHA-256 against the metainfo), so delta is an optimization,
never a trust change: the worst a wrong recipe/base can do is waste the
copy and fall back. Prefilled progress persists through the normal piece
bitfield, so the swarm download that follows sees exactly a resumable
partial.

Default OFF (YAML ``delta:`` on agent + origin; SIGHUP live-reloads).
Knob table and rollout runbook: docs/OPERATIONS.md "Delta transfer".
"""

from __future__ import annotations

import asyncio
import dataclasses
import hashlib
import logging
import time
from typing import NamedTuple, Protocol

from kraken_tpu_torch.core.digest import Digest
from kraken_tpu_torch.core.metainfo import ChunkRecipe, MetaInfo, chunk_fp
from kraken_tpu_torch.p2p.storage import PieceError
from kraken_tpu_torch.utils import failpoints, trace
from kraken_tpu_torch.utils.httputil import HTTPClient, HTTPError, base_url
from kraken_tpu_torch.utils.metrics import REGISTRY
from urllib.parse import quote

_log = logging.getLogger("kraken.p2p.delta")


@dataclasses.dataclass
class DeltaConfig:
    """The YAML ``delta:`` section (agent + origin; live-reloads via
    SIGHUP). Knob table in docs/OPERATIONS.md "Delta transfer"."""

    # Master switch. Shipped OFF: enabling delta is a rollout decision
    # (origins must serve recipes first -- see the runbook), never a
    # config-refresh surprise. On the origin this gates GET .../recipe;
    # on the agent it gates the pull-time planner.
    enabled: bool = False
    # Blobs below this skip planning outright: the recipe/similar round
    # trips cost more than they can save on small blobs. Matches the
    # shipped base.yaml value (the OPERATIONS.md knob table documents
    # both as 4 MiB).
    min_blob_bytes: int = 4 << 20
    # How many locally-held /similar candidates to diff before picking
    # the base with the most covered bytes.
    max_bases: int = 3
    # /similar candidates below this estimated Jaccard are ignored.
    min_jaccard: float = 0.1
    # A partially-covered piece is delta-assembled (local copies + range
    # GETs for the holes) only when the base covers at least this
    # fraction of it; below, the whole piece rides the swarm -- range
    # requests for slivers cost more than they save.
    min_piece_cover: float = 0.25
    # Fetch need spans of partially-covered pieces as origin byte-range
    # GETs. Off = only fully-covered pieces are delta-assembled and
    # everything else rides the swarm.
    range_fetch: bool = True

    @classmethod
    def from_dict(cls, doc: dict | None) -> "DeltaConfig":
        doc = dict(doc or {})
        allowed = {f.name for f in dataclasses.fields(cls)}
        unknown = set(doc) - allowed
        if unknown:
            raise ValueError(f"unknown delta config keys: {sorted(unknown)}")
        return cls(**doc)


class DeltaClient(Protocol):
    """What the planner needs from the control plane (TrackerClient)."""

    async def get_recipe(
        self, namespace: str, d: Digest
    ) -> tuple[ChunkRecipe, str]: ...

    async def similar(self, namespace: str, d: Digest) -> list[dict]: ...


class HaveSpan(NamedTuple):
    """One target chunk a cached base also holds: copy ``size`` bytes
    from ``base_off`` in base number ``base`` (index into the pull's
    selected-base list) to ``target_off`` in the target, valid only if
    the copied bytes still hash to ``fp``."""

    target_off: int
    size: int
    base_off: int
    fp: int
    base: int = 0


def diff_recipes(
    target: ChunkRecipe, base: ChunkRecipe
) -> tuple[list[HaveSpan], list[tuple[int, int]]]:
    """Partition the target blob against ONE base: per-chunk ``have``
    spans (fp-verifiable copies) and merged ``(offset, size)`` ``need``
    spans. The single-base view of :func:`diff_recipes_multi`.

    Invariant (property-tested): the have spans plus the need spans tile
    ``[0, target.length)`` exactly -- no overlap, no gap. Matching is by
    ``(fp, size)``; a fingerprint collision between different-sized
    chunks therefore cannot mispair, and a same-size collision is caught
    by the copy-time re-hash.
    """
    return diff_recipes_multi(target, [base])


def diff_recipes_multi(
    target: ChunkRecipe, bases: list[ChunkRecipe]
) -> tuple[list[HaveSpan], list[tuple[int, int]]]:
    """Partition the target against the UNION of several bases: each
    target chunk copies from the first base (in list order) that holds
    its ``(fp, size)``; chunks no base holds merge into need spans. The
    same tiling invariant as the single-base diff, property-tested over
    both."""
    base_map: dict[tuple[int, int], tuple[int, int]] = {}
    for i, base in enumerate(bases):
        for fp, off, size in base.chunks():
            base_map.setdefault((fp, size), (i, off))
    haves: list[HaveSpan] = []
    needs: list[tuple[int, int]] = []
    for fp, off, size in target.chunks():
        b = base_map.get((fp, size))
        if b is not None:
            haves.append(HaveSpan(off, size, b[1], fp, b[0]))
        elif needs and needs[-1][0] + needs[-1][1] == off:
            needs[-1] = (needs[-1][0], needs[-1][1] + size)
        else:
            needs.append((off, size))
    return haves, needs


def pick_cover_bases(
    target: ChunkRecipe,
    candidates: list[tuple[Digest, ChunkRecipe]],
    max_bases: int,
) -> list[tuple[Digest, ChunkRecipe]]:
    """Greedy set-cover over recipe fps: repeatedly take the candidate
    adding the most not-yet-covered target bytes, stop at ``max_bases``
    or zero marginal gain. Build-over-build corpora split shared content
    across SEVERAL cached prior builds -- union coverage is the ROADMAP
    ceiling (0.25-0.51 vs 0.16-0.28 single-base on the headline corpus).
    Greedy is the classic ln(n)-approximation and exact for the common
    two-base case."""
    remaining: dict[tuple[int, int], int] = {}
    for fp, _off, size in target.chunks():
        key = (fp, size)
        remaining[key] = remaining.get(key, 0) + size
    cand_keys = [
        (d, recipe, {(fp, size) for fp, _o, size in recipe.chunks()})
        for d, recipe in candidates
    ]
    picked: list[tuple[Digest, ChunkRecipe]] = []
    while len(picked) < max_bases and cand_keys and remaining:
        best_i, best_gain = -1, 0
        for i, (_d, _r, keys) in enumerate(cand_keys):
            gain = sum(remaining.get(k, 0) for k in keys)
            if gain > best_gain:
                best_i, best_gain = i, gain
        if best_i < 0:
            break
        d, recipe, keys = cand_keys.pop(best_i)
        picked.append((d, recipe))
        for k in keys:
            remaining.pop(k, None)
    return picked


class _RangeUnsupported(Exception):
    """The origin answered 200 to a Range request: no byte-range support
    behind this URL -- disable ranged assembly for the rest of the pull."""


class DeltaPlanner:
    """Agent-side delta pull: plan -> copy -> fetch, before the swarm.

    One per node, shared by every download; ``prefill`` runs inside the
    scheduler's per-digest download coalescer, so at most one prefill per
    blob is in flight. Failures at ANY stage degrade to the normal full
    swarm pull -- the planner never fails a download.
    """

    def __init__(
        self,
        store,  # store.CAStore
        archive,  # p2p.storage.AgentTorrentArchive
        client: DeltaClient,
        config: DeltaConfig | None = None,
        http: HTTPClient | None = None,
    ):
        self.store = store
        self.archive = archive
        self.client = client
        self.config = config or DeltaConfig()
        # Ranged reads fail FAST to the swarm (retries=0): the swarm path
        # is the retry, and a struggling origin should shed this load.
        self._http = http or HTTPClient(retries=0)
        self._pulls = REGISTRY.counter(
            "delta_pulls_total",
            "Delta-planned pulls by outcome (delta = >=1 piece prefilled)",
        )
        self._copied = REGISTRY.counter(
            "delta_bytes_copied_local_total",
            "Bytes copied out of a local delta base instead of fetched",
        )
        self._fetched = REGISTRY.counter(
            "delta_bytes_fetched_total",
            "Bytes fetched as origin byte ranges for delta-assembled pieces",
        )
        self._recipe_misses = REGISTRY.counter(
            "delta_recipe_misses_total",
            "Chunk-recipe fetches that missed (disabled origin, evicted "
            "sidecar, or error), by which side of the diff",
        )
        self._chunk_rejects = REGISTRY.counter(
            "delta_chunk_verify_failures_total",
            "Base chunks whose bytes no longer hash to the recipe fp "
            "(corrupt/stale local base); the piece fell back to the swarm",
        )
        self._piece_rejects = REGISTRY.counter(
            "delta_piece_verify_failures_total",
            "Delta-assembled pieces that failed the piece-hash verify "
            "and fell back to the swarm",
        )
        self._bases_used = REGISTRY.counter(
            "delta_bases_used_total",
            "Cached near-duplicate bases the multi-base planner copied "
            "from, summed over delta pulls (>1 per pull = union cover)",
        )
        # The port's own split of a prefill's wall (the reference keeps
        # none), so the stages can be read from outside the process.
        self._seconds = REGISTRY.counter(
            "delta_stage_seconds_total",
            "Seconds of delta prefills by stage: prefill (the whole), plan "
            "(recipe, /similar, base recipes, diff), copy (local copies, "
            "recheck included), recheck (hashlib chunk_fp of base chunks), "
            "fetch (origin range GETs), write (piece verify and write)",
        )
        self._converts = REGISTRY.counter(
            "chunkstore_converts_total",
            "Completed pulls converted to manifest + refcounted chunks, "
            "by outcome (converted / skipped / mismatch / error)",
        )
        # Recipes this planner fetched recently, kept for the chunk-tier
        # handover: a completed pull converts to manifest + chunks using
        # the SAME table the plan used -- no re-fetch, no re-chunk.
        self._recipes: dict[str, ChunkRecipe] = {}

    _RECIPE_KEEP = 128
    # chunk_fp seconds inside _copy_piece (one worker thread at a time).
    _recheck_s = 0.0

    def _remember_recipe(self, recipe: ChunkRecipe) -> None:
        self._recipes[recipe.digest.hex] = recipe
        while len(self._recipes) > self._RECIPE_KEEP:
            self._recipes.pop(next(iter(self._recipes)))

    async def close(self) -> None:
        await self._http.close()

    # -- plan ---------------------------------------------------------------

    async def prefill(self, metainfo: MetaInfo, namespace: str) -> dict | None:
        """Try to assemble pieces of ``metainfo`` from a local delta base
        before the swarm pull. Returns a summary dict (or None when delta
        did not apply). Never raises for plan/copy/fetch failures -- the
        caller's swarm download is the fallback for everything."""
        cfg = self.config
        d = metainfo.digest
        if (
            not cfg.enabled
            or metainfo.length < cfg.min_blob_bytes
            or self.store.in_cache(d)
        ):
            return None
        t0 = time.perf_counter()
        try:
            return await self._prefill(metainfo, namespace)
        finally:
            self._seconds.inc(time.perf_counter() - t0, stage="prefill")

    async def _prefill(self, metainfo: MetaInfo, namespace: str) -> dict | None:
        d = metainfo.digest
        t_plan = time.perf_counter()
        with trace.span(
            "delta.plan", digest=d.hex[:12], namespace=namespace
        ) as sp:
            try:
                target, origin_addr = await self.client.get_recipe(namespace, d)
            except Exception as e:
                self._recipe_misses.inc(side="target")
                self._pulls.inc(outcome="recipe_miss")
                _log.debug(
                    "delta: no recipe for target; full pull",
                    extra={"digest": d.hex, "error": repr(e)},
                )
                return None
            if target.length != metainfo.length:
                # A recipe that disagrees with the metainfo cannot be
                # planned against (stale sidecar vs a digest collision is
                # not worth distinguishing here -- both mean "don't").
                self._recipe_misses.inc(side="target")
                self._pulls.inc(outcome="recipe_miss")
                return None
            # Remember the validated recipe for the chunk-tier handover
            # (chunk_completed) -- even a no-base first pull converts.
            self._remember_recipe(target)
            picked = await self._pick_bases(namespace, d, target)
            if not picked:
                self._pulls.inc(outcome="no_base")
                return None
            bases = [b for b, _r in picked]
            haves, _needs = diff_recipes_multi(
                target, [r for _b, r in picked]
            )
            if sp is not None:
                sp.set(
                    base=bases[0].hex[:12],
                    bases=len(bases),
                    have_bytes=sum(h.size for h in haves),
                )
        plan_s = time.perf_counter() - t_plan
        self._seconds.inc(plan_s, stage="plan")
        if failpoints.fire("p2p.delta.base.evict"):
            # Model cache eviction racing the plan->copy window: the base
            # bytes vanish under the planner, which must fall back to the
            # full swarm pull cleanly (tests/test_delta.py chaos tier).
            for b in bases:
                self.store.delete_cache_file(b)
        result = {
            "base": bases[0].hex,
            "bases": [b.hex for b in bases],
            "bases_used": 0,
            "pieces": 0,
            "copied": 0,
            "fetched": 0,
            "seconds": {"plan": plan_s, "copy": 0.0, "recheck": 0.0,
                        "fetch": 0.0, "write": 0.0},
        }
        torrent = self.archive.create_torrent(metainfo)
        try:
            if not torrent.complete():
                await self._assemble(
                    torrent, metainfo, namespace, bases, haves,
                    origin_addr, result,
                )
                # Hand progress over NOW: the scheduler builds a fresh
                # Torrent from the persisted bitfield immediately after,
                # and the debounced flusher's window would lose pieces.
                await torrent.flush_bits()
        finally:
            torrent.close()
        self._pulls.inc(outcome="delta" if result["pieces"] else "no_cover")
        self._copied.inc(result["copied"])
        self._fetched.inc(result["fetched"])
        self._bases_used.inc(result["bases_used"])
        for stage, secs in result["seconds"].items():
            if stage != "plan":
                self._seconds.inc(secs, stage=stage)
        _log.info(
            "delta prefill",
            extra={
                "digest": d.hex,
                "bases": result["bases"],
                "bases_used": result["bases_used"],
                "pieces": result["pieces"],
                "copied_bytes": result["copied"],
                "fetched_bytes": result["fetched"],
                "seconds": {k: round(v, 6) for k, v in result["seconds"].items()},
            },
        )
        return result

    async def _pick_bases(
        self, namespace: str, d: Digest, target: ChunkRecipe
    ) -> list[tuple[Digest, ChunkRecipe]]:
        """Locally-held /similar candidates, greedy set-cover selected.

        Up to ``2 * max_bases`` cached candidates fetch recipes (the
        selection needs slack to beat best-of-N), then
        :func:`pick_cover_bases` keeps the ``max_bases`` whose UNION
        covers the most target bytes -- several prior builds each
        holding a different slice of the target beat the single best
        base (ROADMAP item 2's multi-base ceiling). Candidates whose
        manifest/recipe fetch fails just drop out; zero usable
        candidates = full pull."""
        try:
            sims = await self.client.similar(namespace, d)
        except Exception as e:
            _log.debug(
                "delta: /similar unavailable; full pull",
                extra={"digest": d.hex, "error": repr(e)},
            )
            return []
        candidates: list[tuple[Digest, ChunkRecipe]] = []
        for s in sims:  # kt-lint: disable=retry-without-deadline  # bounded to 2*max_bases local candidates; each recipe fetch is ONE budgeted HTTPClient request and a failure drops the candidate, never retries
            try:
                score = float(s.get("score", 0.0))
                base_d = Digest.from_hex(s["digest"])
            except (KeyError, TypeError, ValueError):
                continue
            if score < self.config.min_jaccard:
                continue
            if not self.store.in_cache(base_d):
                continue
            if len(candidates) >= 2 * self.config.max_bases:
                break
            try:
                base_recipe, _addr = await self.client.get_recipe(
                    namespace, base_d
                )
            except Exception:
                self._recipe_misses.inc(side="base")
                continue
            candidates.append((base_d, base_recipe))
        return pick_cover_bases(target, candidates, self.config.max_bases)

    # -- chunk-tier handover ------------------------------------------------

    async def chunk_completed(self, metainfo: MetaInfo, namespace: str) -> dict | None:
        """Convert a just-completed pull into the chunk tier (manifest +
        refcounted chunks) using the recipe the prefill fetched -- the
        scheduler calls this after every download when the tier is
        enabled. A near-duplicate of a cached build then stores only its
        unique chunks at rest, and the flat file the swarm wrote is
        dropped. Failures (recipe absent, fp/byte mismatch, tier IO)
        leave the blob flat -- conversion is an optimization, never a
        durability change."""
        cs = getattr(self.store, "chunkstore", None)
        if cs is None or not cs.config.enabled:
            return None
        d = metainfo.digest
        if metainfo.length < cs.config.min_blob_bytes:
            return None
        recipe = self._recipes.get(d.hex)
        if recipe is None or recipe.length != metainfo.length:
            return None
        with trace.span(
            "delta.chunk_convert", digest=d.hex[:12], namespace=namespace
        ):
            try:
                res = await asyncio.to_thread(
                    self.store.convert_to_chunks,
                    d, list(recipe.fps), list(recipe.sizes),
                )
            except Exception:
                self._converts.inc(outcome="error")
                raise
        if res is None:
            # Absent / already chunked / recipe-byte mismatch: the
            # store kept whichever representation it had.
            self._converts.inc(outcome="mismatch")
            return None
        self._converts.inc(outcome="converted")
        _log.info(
            "blob converted to chunk tier",
            extra={
                "digest": d.hex,
                "new_bytes": res["new_bytes"],
                "dup_bytes": res["dup_bytes"],
            },
        )
        return res

    # -- copy + fetch -------------------------------------------------------

    async def _assemble(
        self,
        torrent,
        metainfo: MetaInfo,
        namespace: str,
        bases: list[Digest],
        haves: list[HaveSpan],
        origin_addr: str,
        result: dict,
    ) -> None:
        plen = metainfo.piece_length
        cover: dict[int, list[HaveSpan]] = {}
        for h in haves:
            first = h.target_off // plen
            last = (h.target_off + h.size - 1) // plen
            for i in range(first, last + 1):
                cover.setdefault(i, []).append(h)
        ranged_ok = bool(origin_addr) and self.config.range_fetch
        url = (
            f"{base_url(origin_addr)}/namespace/"
            f"{quote(namespace, safe='')}/blobs/{metainfo.digest.hex}"
            if origin_addr
            else ""
        )
        # Per-base reader lifecycle: one positional-read handle per
        # selected base, opened up front, closed in the finally. A base
        # evicted between plan and copy just drops out (its spans'
        # pieces ride the swarm; spans of the surviving bases still
        # copy). open_cache_reader composes over BOTH representations,
        # so a base already living in the chunk tier serves copies too.
        readers: list = []
        alive = 0
        for b in bases:
            try:
                readers.append(self.store.open_cache_reader(b))
                alive += 1
            except KeyError:
                readers.append(None)
                _log.debug(
                    "delta: base evicted before copy",
                    extra={"base": b.hex},
                )
        if alive == 0:
            return
        result["bases_used"] = alive
        # Per-chunk verify verdicts, shared across pieces: a chunk that
        # straddles a piece boundary is read+hashed once, not once per
        # piece, and a corrupt one is counted once. _copy_piece calls
        # run one at a time (awaited below), so no locking.
        verified: dict[HaveSpan, bool] = {}
        secs = result["seconds"]
        try:
            with trace.span(
                "delta.copy", digest=metainfo.digest.hex[:12],
                base=bases[0].hex[:12], bases=len(bases),
            ):
                for i in torrent.missing_pieces():
                    spans = cover.get(i)
                    if not spans:
                        continue
                    p0 = i * plen
                    pl = metainfo.piece_length_of(i)
                    t_copy, r0 = time.perf_counter(), self._recheck_s
                    out = await asyncio.to_thread(
                        self._copy_piece, readers, p0, pl, spans, verified
                    )
                    secs["copy"] += time.perf_counter() - t_copy
                    secs["recheck"] += self._recheck_s - r0
                    if out is None:
                        continue  # fp reject: this piece rides the swarm
                    buf, holes, copied = out
                    if holes:
                        if (
                            not ranged_ok
                            or copied < self.config.min_piece_cover * pl
                        ):
                            continue
                        t_fetch = time.perf_counter()
                        try:
                            with trace.span(
                                "delta.fetch", piece=i, spans=len(holes),
                            ):
                                fetched = await self._fetch_holes(
                                    url, p0, holes, buf
                                )
                        except _RangeUnsupported:
                            ranged_ok = False
                            continue
                        except Exception as e:
                            # ONE failure budget for the whole pull: a
                            # dead/partitioned origin must not be
                            # re-dialed (and re-timed-out) per piece --
                            # serial 60 s stalls inside prefill would
                            # make delta slower than the swarm it is
                            # supposed to beat. Fully-covered pieces
                            # still assemble; the rest ride the swarm.
                            ranged_ok = False
                            _log.debug(
                                "delta: range fetch failed; ranged "
                                "assembly off for this pull",
                                extra={"piece": i, "error": repr(e)},
                            )
                            continue
                        finally:
                            secs["fetch"] += time.perf_counter() - t_fetch
                        result["fetched"] += fetched
                    t_write = time.perf_counter()
                    try:
                        await torrent.write_piece(i, bytes(buf))
                    except PieceError:
                        # The assembled piece does not hash to the
                        # metainfo (stale recipe, fp collision): the
                        # unchanged verify caught it; swarm re-fetches.
                        self._piece_rejects.inc()
                        continue
                    finally:
                        secs["write"] += time.perf_counter() - t_write
                    result["copied"] += copied
                    result["pieces"] += 1
        finally:
            for r in readers:
                if r is not None:
                    r.close()

    def _copy_piece(
        self,
        readers: list,
        p0: int,
        pl: int,
        spans: list[HaveSpan],
        verified: dict[HaveSpan, bool],
    ) -> tuple[bytearray, list[tuple[int, int]], int] | None:
        """Build piece ``[p0, p0+pl)`` from base chunks (worker thread).

        ``readers[h.base]`` is the span's base handle (None = that base
        was evicted before copy; its spans reject so the piece rides the
        swarm). Returns ``(buf, holes, copied_bytes)`` where ``holes``
        are the piece-relative ``(off, size)`` intervals no verified
        chunk covered, or None when a chunk failed its fp re-verify
        (corrupt base: the piece must not be assembled from it).
        ``verified`` carries per-chunk verdicts across this pull's
        pieces: a chunk straddling a piece boundary is fully read +
        hashed by the first piece that sees it, and later pieces read
        only their overlap."""
        buf = bytearray(pl)
        filled: list[tuple[int, int]] = []
        copied = 0
        for h in spans:
            lo = max(h.target_off, p0)
            hi = min(h.target_off + h.size, p0 + pl)
            if lo >= hi:
                continue
            ok = verified.get(h)
            if ok is False:
                return None
            reader = readers[h.base] if h.base < len(readers) else None
            if reader is None:
                return None  # base gone: this piece rides the swarm
            try:
                if ok is None:
                    chunk = reader.pread(h.size, h.base_off)
                    t_fp = time.perf_counter()
                    same = len(chunk) == h.size and chunk_fp(chunk) == h.fp
                    self._recheck_s += time.perf_counter() - t_fp
                    if not same:
                        # The base no longer holds what the recipe says
                        # (at-rest corruption, or a recipe/blob
                        # mismatch): nothing copied from it is trusted.
                        self._chunk_rejects.inc()
                        verified[h] = False
                        return None
                    verified[h] = True
                    part = chunk[lo - h.target_off : hi - h.target_off]
                else:
                    # Verified by an earlier piece: read just the overlap.
                    part = reader.pread(
                        hi - lo, h.base_off + (lo - h.target_off)
                    )
                    if len(part) != hi - lo:
                        # Immutable-CAS reads can't short-read inside the
                        # file; treat anything else as a reject, not
                        # silent holes.
                        self._chunk_rejects.inc()
                        verified[h] = False
                        return None
            except OSError:
                # A chunk-backed base whose chunk file vanished under us
                # (quarantine race): same verdict as a failed re-hash.
                self._chunk_rejects.inc()
                verified[h] = False
                return None
            rel = lo - p0
            buf[rel : rel + (hi - lo)] = part
            filled.append((rel, hi - lo))
            copied += hi - lo
        filled.sort()
        holes: list[tuple[int, int]] = []
        pos = 0
        for off, size in filled:
            if off > pos:
                holes.append((pos, off - pos))
            pos = max(pos, off + size)
        if pos < pl:
            holes.append((pos, pl - pos))
        return buf, holes, copied

    # Concurrent Range GETs per piece: build-over-build coverage
    # alternates have/need, so a piece often carries several holes --
    # fetching them serially costs sum(holes) x RTT on a WAN origin.
    _FETCH_CONCURRENCY = 4

    async def _fetch_holes(
        self,
        url: str,
        p0: int,
        holes: list[tuple[int, int]],
        buf: bytearray,
    ) -> int:
        """Fill ``holes`` (piece-relative) of ``buf`` via origin Range
        GETs (up to ``_FETCH_CONCURRENCY`` in flight); returns bytes
        fetched. Raises :class:`_RangeUnsupported` when the origin
        answers 200 (whole blob) to a range request; that error wins
        over transient ones so the caller turns ranging off rather than
        retrying an origin that will never serve spans."""
        sem = asyncio.Semaphore(self._FETCH_CONCURRENCY)

        async def fetch_one(rel: int, size: int) -> int:
            a = p0 + rel
            async with sem:
                try:
                    body = await self._http.get(
                        url,
                        headers={"Range": f"bytes={a}-{a + size - 1}"},
                        ok_statuses=(206,),
                        # 200 = no range support behind this URL. Abort
                        # (no body read) instead of buffering the WHOLE
                        # blob just to learn it can't serve spans.
                        abort_statuses=(200,),
                        retry_5xx=False,
                    )
                except HTTPError as e:
                    if e.status == 200:
                        raise _RangeUnsupported(url) from None
                    raise
            if len(body) != size:
                raise PieceError(
                    f"range GET returned {len(body)} bytes, wanted {size}"
                )
            buf[rel : rel + size] = body
            return size

        results = await asyncio.gather(
            *(fetch_one(rel, size) for rel, size in holes),
            return_exceptions=True,
        )
        errs = [r for r in results if isinstance(r, BaseException)]
        for e in errs:
            if isinstance(e, _RangeUnsupported):
                raise e
        if errs:
            raise errs[0]
        return sum(results)
