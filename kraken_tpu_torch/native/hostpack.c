/* Host-side piece packer: the feeder half of the packed hash path.
 *
 * The packed SHA-256 kernel (csrc/sha256_packed.cu) consumes word-major
 * tiles ([T, NB, 16, 1024] big-endian u32: word j of block b for the 1024
 * pieces of tile t, pieces laid out minor, so one word of 32 neighbouring
 * pieces is one contiguous 128-byte line).  This is the layout of
 * kraken_tpu/native/hostpack.c, of which this file is the port's copy:
 * both packers write the same bytes.  Packing on the host pays off on
 * feeder hosts with spare cores, because the transform replaces the
 * staging memcpy the feeder performs anyway (pieces arrive from NIC/disk
 * and must be copied into the upload buffer regardless).
 *
 * 16x16-u32 blocked transpose + byte swap; one (pieces-chunk, block)
 * working set is 1 KiB src + 1 KiB dst, L1-resident.  The work
 * decomposes into independent 16-piece groups, parallelized over a
 * pthread pool in kt_pack_tiles_mt (each group touches a disjoint
 * 16-lane stripe of every destination word tile, so workers never share
 * cache lines within a 64 B store row).
 */

#include <stdint.h>
#include <inttypes.h>
#include <pthread.h>
#include <stddef.h>
#include <string.h>

#if defined(__x86_64__)
#include <immintrin.h>
#endif

#define KT_TILE 1024u /* pieces per packed tile */
#define KT_GRP 16u    /* pieces per work unit (one 16x16 transpose block) */
#define KT_GRP_PER_TILE (KT_TILE / KT_GRP)
#define KT_MAX_THREADS 64

/* One contiguous range of 16-piece groups; group g lives in tile
 * g / KT_GRP_PER_TILE at piece offset (g % KT_GRP_PER_TILE) * 16. */
typedef struct {
    const uint8_t *src;
    uint32_t *dst;
    size_t piece_len;
    size_t nb_out;
    size_t g_start, g_end;
} kt_pack_job;

static void pack_range_scalar(const kt_pack_job *job)
{
    const size_t piece_len = job->piece_len;
    const size_t nbd = piece_len / 64;

    for (size_t g = job->g_start; g < job->g_end; g++) {
        const size_t t = g / KT_GRP_PER_TILE;
        const size_t p0 = (g % KT_GRP_PER_TILE) * KT_GRP;
        const uint8_t *sp0 = job->src + t * KT_TILE * piece_len;
        uint32_t *dp0 = job->dst + t * job->nb_out * 16 * KT_TILE;
        for (size_t b = 0; b < nbd; b++) {
            uint32_t *dpb = dp0 + b * 16 * KT_TILE;
            for (size_t pp = 0; pp < KT_GRP; pp++) {
                const uint8_t *s = sp0 + (p0 + pp) * piece_len + b * 64;
                uint32_t *d = dpb + p0 + pp;
                for (size_t j = 0; j < 16; j++) {
                    uint32_t v;
                    memcpy(&v, s + 4 * j, 4);
                    d[j * KT_TILE] = __builtin_bswap32(v);
                }
            }
        }
    }
}

#if defined(__x86_64__)
/* In-register 16x16 u32 transpose: 3 stages of unpack/lane shuffles.
 * r[i] holds piece i's 16 words on entry, word j's 16 pieces on exit. */
__attribute__((target("avx512f,avx512bw")))
static inline void tr16x16(__m512i r[16])
{
    __m512i t[16], u[16], v[16];
    for (int i = 0; i < 8; i++) {
        t[2 * i] = _mm512_unpacklo_epi32(r[2 * i], r[2 * i + 1]);
        t[2 * i + 1] = _mm512_unpackhi_epi32(r[2 * i], r[2 * i + 1]);
    }
    for (int q = 0; q < 4; q++) {
        u[4 * q + 0] = _mm512_unpacklo_epi64(t[4 * q + 0], t[4 * q + 2]);
        u[4 * q + 1] = _mm512_unpackhi_epi64(t[4 * q + 0], t[4 * q + 2]);
        u[4 * q + 2] = _mm512_unpacklo_epi64(t[4 * q + 1], t[4 * q + 3]);
        u[4 * q + 3] = _mm512_unpackhi_epi64(t[4 * q + 1], t[4 * q + 3]);
    }
    for (int i = 0; i < 4; i++) {
        v[i] = _mm512_shuffle_i32x4(u[i], u[i + 4], 0x88);
        v[i + 4] = _mm512_shuffle_i32x4(u[i], u[i + 4], 0xdd);
        v[i + 8] = _mm512_shuffle_i32x4(u[i + 8], u[i + 12], 0x88);
        v[i + 12] = _mm512_shuffle_i32x4(u[i + 8], u[i + 12], 0xdd);
    }
    for (int i = 0; i < 4; i++) {
        r[i] = _mm512_shuffle_i32x4(v[i], v[i + 8], 0x88);
        r[i + 8] = _mm512_shuffle_i32x4(v[i], v[i + 8], 0xdd);
        r[i + 4] = _mm512_shuffle_i32x4(v[i + 4], v[i + 12], 0x88);
        r[i + 12] = _mm512_shuffle_i32x4(v[i + 4], v[i + 12], 0xdd);
    }
}

/* AVX-512: contiguous 64B row loads, one vpshufb byte swap per row,
 * in-register transpose, contiguous 64B row stores. */
__attribute__((target("avx512f,avx512bw")))
static void pack_range_avx512(const kt_pack_job *job)
{
    const size_t piece_len = job->piece_len;
    const size_t nbd = piece_len / 64;
    const __m512i bswap = _mm512_broadcast_i32x4(
        _mm_setr_epi8(3, 2, 1, 0, 7, 6, 5, 4, 11, 10, 9, 8, 15, 14, 13, 12));

    for (size_t g = job->g_start; g < job->g_end; g++) {
        const size_t t = g / KT_GRP_PER_TILE;
        const size_t p0 = (g % KT_GRP_PER_TILE) * KT_GRP;
        const uint8_t *sp0 = job->src + t * KT_TILE * piece_len;
        uint32_t *dp0 = job->dst + t * job->nb_out * 16 * KT_TILE;
        /* b inner: the 16 source pieces stream sequentially through
         * their blocks (hardware prefetch friendly). */
        for (size_t b = 0; b < nbd; b++) {
            uint32_t *dpb = dp0 + b * 16 * KT_TILE + p0;
            __m512i r[16];
            for (int pp = 0; pp < 16; pp++) {
                r[pp] = _mm512_loadu_si512(
                    (const void *)(sp0 + (p0 + pp) * piece_len + b * 64));
                r[pp] = _mm512_shuffle_epi8(r[pp], bswap);
            }
            tr16x16(r);
            if (((uintptr_t)dpb & 63) == 0) {
                /* Fresh lines, never re-read before the device upload:
                 * non-temporal stores skip the read-for-ownership that
                 * otherwise doubles write traffic. */
                for (int j = 0; j < 16; j++)
                    _mm512_stream_si512(
                        (__m512i *)(dpb + j * KT_TILE), r[j]);
            } else {
                for (int j = 0; j < 16; j++)
                    _mm512_storeu_si512((void *)(dpb + j * KT_TILE), r[j]);
            }
        }
    }
    _mm_sfence();
}
#endif

static void pack_range(const kt_pack_job *job)
{
#if defined(__x86_64__)
    if (__builtin_cpu_supports("avx512f") &&
        __builtin_cpu_supports("avx512bw") &&
        job->piece_len <= (1u << 27)) {
        pack_range_avx512(job);
        return;
    }
#endif
    pack_range_scalar(job);
}

static void *pack_worker(void *arg)
{
    pack_range((const kt_pack_job *)arg);
    return NULL;
}

/* src: n_pieces x piece_len bytes, piece-major (natural layout).
 * dst: (n_pieces/1024) x nb_out x 16 x 1024 u32 (word-major tiles).
 * n_pieces % 1024 == 0 and piece_len % 64 == 0 (caller pads);
 * nb_out >= piece_len/64 (trailing groups are left untouched).
 * n_threads <= 1 packs on the calling thread. */
void kt_pack_tiles_mt(const uint8_t *restrict src, uint32_t *restrict dst,
                      size_t n_pieces, size_t piece_len, size_t nb_out,
                      size_t n_threads)
{
    const size_t n_groups = n_pieces / KT_GRP;
    if (n_threads > KT_MAX_THREADS)
        n_threads = KT_MAX_THREADS;
    if (n_threads > n_groups)
        n_threads = n_groups;

    if (n_threads <= 1) {
        kt_pack_job job = {src, dst, piece_len, nb_out, 0, n_groups};
        pack_range(&job);
        return;
    }

    pthread_t tids[KT_MAX_THREADS];
    kt_pack_job jobs[KT_MAX_THREADS];
    size_t spawned = 0;
    const size_t per = n_groups / n_threads;
    const size_t rem = n_groups % n_threads;
    size_t g = 0;
    for (size_t i = 0; i < n_threads; i++) {
        const size_t take = per + (i < rem ? 1 : 0);
        jobs[i] = (kt_pack_job){src, dst, piece_len, nb_out, g, g + take};
        g += take;
    }
    for (size_t i = 1; i < n_threads; i++) {
        if (pthread_create(&tids[i], NULL, pack_worker, &jobs[i]) != 0)
            break; /* fall back: run unspawned shards inline below */
        spawned = i;
    }
    /* Shard 0 plus any shards whose thread failed to spawn. */
    pack_range(&jobs[0]);
    for (size_t i = spawned + 1; i < n_threads; i++)
        pack_range(&jobs[i]);
    for (size_t i = 1; i <= spawned; i++)
        pthread_join(tids[i], NULL);
}

void kt_pack_tiles(const uint8_t *restrict src, uint32_t *restrict dst,
                   size_t n_pieces, size_t piece_len, size_t nb_out)
{
    kt_pack_tiles_mt(src, dst, n_pieces, piece_len, nb_out, 1);
}

/* Cooperative entry point: pack ONLY 16-piece groups [g_lo, g_hi) of the
 * same (src, dst) pair, on the calling thread.  This is how HashPool
 * pack workers parallelize from Python: ctypes drops the GIL for the
 * duration of every foreign call, so N workers each packing a disjoint
 * group range scale with cores without the interpreter serializing them
 * (and without this library owning a thread pool -- scheduling stays
 * with the shared HashPool, where pack work and hash work are visible
 * to the same occupancy gauges).  Groups write disjoint 16-lane stripes
 * of every destination word tile, so ranges never share cache lines
 * within a 64 B store row.  Out-of-range bounds are clamped: the caller
 * computes ranges from n_pieces / 16 and a short final shard is legal. */
void kt_pack_tiles_range(const uint8_t *restrict src, uint32_t *restrict dst,
                         size_t n_pieces, size_t piece_len, size_t nb_out,
                         size_t g_lo, size_t g_hi)
{
    const size_t n_groups = n_pieces / KT_GRP;
    if (g_hi > n_groups)
        g_hi = n_groups;
    if (g_lo >= g_hi)
        return;
    kt_pack_job job = {src, dst, piece_len, nb_out, g_lo, g_hi};
    pack_range(&job);
}

/* ---------------------------------------------------------------------
 * FastCDC sequential chunker (host plane).
 *
 * Exactly kraken_tpu/ops/cdc.py chunk_reference: 32-bit gear rolling
 * hash h = (h << 1) + gear(b), FastCDC normalized cut policy (strict
 * mask through avg_size, loose mask through max_size, hard min/max
 * bounds). This is the host plane for streaming workloads where the
 * bytes never visit the card (e.g. origin-side dedup scans). The gear
 * function is the framework constant defined arithmetically in
 * kraken_tpu/ops/cdc.py; boundaries are a persistent on-disk contract,
 * so the implementations must never diverge (pinned against the
 * kraken_tpu chunker in tests/test_torch_packed.py).
 * ------------------------------------------------------------------ */

static uint32_t kt_gear_fn(uint32_t b)
{
    uint32_t x = (b + 1u) * 0x9E3779B1u;
    x ^= x >> 15;
    x *= 0x85EBCA77u;
    x ^= x >> 13;
    return x;
}

/* Chunk data[0..n) into cut end-offsets (exclusive). Returns the number
 * of cuts written (<= cuts_cap; callers size cuts_cap >= n/min_size + 1
 * so truncation cannot happen). */
size_t kt_cdc_chunk(const uint8_t *restrict data, size_t n,
                    size_t min_size, size_t avg_size, size_t max_size,
                    uint32_t mask_strict, uint32_t mask_loose,
                    uint64_t *restrict cuts_out, size_t cuts_cap)
{
    uint32_t gear[256];
    for (uint32_t i = 0; i < 256; i++)
        gear[i] = kt_gear_fn(i);
    size_t ncuts = 0;
    size_t start = 0;
    while (start < n && ncuts < cuts_cap) {
        const size_t remaining = n - start;
        if (remaining <= min_size) {
            cuts_out[ncuts++] = n;
            break;
        }
        const size_t limit = remaining < max_size ? remaining : max_size;
        const size_t norm_point = avg_size < limit ? avg_size : limit;
        const uint8_t *p = data + start;
        uint32_t h = 0;
        size_t end = start + limit;
        size_t i = 0;
        for (; i < min_size; i++) /* uncuttable zone: hash only */
            h = (h << 1) + gear[p[i]];
        for (; i < norm_point; i++) {
            h = (h << 1) + gear[p[i]];
            if ((h & mask_strict) == 0) {
                end = start + i + 1;
                goto cut;
            }
        }
        for (; i < limit; i++) {
            h = (h << 1) + gear[p[i]];
            if ((h & mask_loose) == 0) {
                end = start + i + 1;
                goto cut;
            }
        }
    cut:
        cuts_out[ncuts++] = end;
        start = end;
    }
    return ncuts;
}
