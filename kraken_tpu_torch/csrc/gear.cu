// FastCDC gear pass on Hopper (sm_90a): the FastCDC candidates of one
// window, compacted on the card.
//
// Replaces kraken_tpu/ops/cdc_pallas.py _gear_pallas (the Pallas kernel of
// _make_kernel) and the compaction of its caller candidate_indices_pallas
// (:116): the gear map g(b), the windowed sum
// h_i = sum_{j=0..31} g(b_{i-j}) << j (mod 2^32), with zero gear values (not
// zero bytes: g(0) != 0) before the blob's offset 0, and the strict and
// loose tests (h & mask) == 0. It writes no mask plane: each candidate
// position p comes out as the code p << 2 | kind (bit 0 strict, bit 1
// loose), in no order; the wrapper sorts them.
//
// What bounds it: the bytes. The window and its 31 bytes of history are
// read once (64 MiB + 31: 0.0200 ms at 3.35 TB/s); the codes written are a
// few KiB. The work (chip_smoke.py GEAR_WORK) is less: with the gear map
// as a lookup in a shared-memory table, a byte costs its extraction and a
// 3-input unsigned min's half on the ALU pipe, the lookup's address and the
// rolling form's shift-add on either pipe, and one shared-memory load:
// 0.0090 ms for a 64 MiB window on 132 SMs at 1.98 GHz (the map computed
// arithmetically, 5 ALU-only operations a byte, would take 0.0201 ms: a
// hair above the bytes). As built, a run of 32 positions issues the SASS
// that chip_smoke.py's build phase counts by pipe (gear_sass_per_byte);
// PERF.md has the counts and the time on the card beside the bound.
//
// The design, against the faults of the kernel it replaces (gear values
// mapped into a shared-memory tile, a barrier, then a 16-position run a
// thread with a 31-value warm-up, and a mask byte a position written):
// - The map: each lane loads its 32 bytes as two 16-byte loads (a warp
//   covers one contiguous KiB) and maps each byte once: a PRMT, an address
//   and one load from a table of the 256 gear values that holds a copy in
//   every bank (gear(b) at [b * 32 + lane]), so a warp's 32 lookups never
//   conflict. No per-byte offset compare and no store a byte. (The map
//   computed in registers -- two multiplies, two shifts, two xors a byte --
//   issued ~40 % more instructions a byte and ran ~25 % longer on an H100:
//   PERF.md.)
// - One block barrier, after the table is built; then nothing is shared
//   between warps. One wave of blocks fills the card, and each warp walks
//   a contiguous span of 1 KiB steps, loading each step's bytes one step
//   ahead.
// - No warm-up re-reads: a lane rolls a local hash from zero,
//   L_i = (L_{i-1} << 1) + g_i. At the run's last position the shift has
//   pushed every older term out, so L_31 is the true windowed hash there;
//   the next lane takes it as P with one shuffle, and every position is
//   h_i = L_i + (P << (i + 1)). Lane 0 takes P from the warp's previous
//   KiB (a shuffle from lane 31); the span's first KiB takes it from a
//   warp-wide sum over the 32 bytes before the span, one byte a lane
//   (a redundant run spread over the lanes: 1 gear map a lane a span,
//   where a redundant run on lane 0 alone would stall the warp 32 steps).
//   The zero-history rule sits in that sum alone, behind a branch that only
//   the blob's first span takes.
// - No mask plane: with top-bit masks, h hits a mask iff h <= ~mask, and
//   the strict mask's bits contain the loose mask's, so a position hits
//   either only if it hits the loose one. A run keeps the unsigned min of
//   its 32 hashes, and only a warp with a run at or below ~mask_l (about
//   one position in 2^14 at the default parameters) takes the rare path:
//   both tests position by position, then one warp-aggregated atomicAdd
//   (popc, a prefix over the lanes) and the codes' stores. The code
//   buffer holds one slot a position, so no candidate is ever dropped.
//
// Buffer layout (kraken_tpu_torch/ops/cdc_cuda.py): buf[kLead + p] is the
// window's byte p, for p < n; buf[kLead - hist .. kLead) is the real
// history before it (0 <= hist <= 31; 0 at the blob's offset 0); earlier
// bytes count as zero gear values. buf holds kLead + ceil(n / kStep) *
// kStep bytes, 16-byte aligned; positions >= n are hashed from whatever
// the padding holds and never written. out[0] is the count of codes and
// out[1 ..] the codes (n + 1 int32 slots, n < 2^29).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps: the 256 bytes of the table
constexpr int kWarps = kThreads / 32;
constexpr int kRun = 32;                 // positions a lane a step
constexpr int kStep = 32 * kRun;         // positions a warp a step: 1 KiB
constexpr int kLead = 32;                // buffer bytes before position 0
constexpr int kWindow = 32;              // bytes of history in the hash
constexpr unsigned kFull = 0xFFFFFFFFu;
static_assert(kThreads == 256, "a block's threads map the table's 256 bytes, one each");

// The arithmetic gear of kraken_tpu/ops/cdc.py _gear_fn_py (a murmur-style
// avalanche of b + 1); a framework constant of the on-disk chunk format.
__device__ __forceinline__ uint32_t gear(uint32_t b) {
  uint32_t x = b * 0x9E3779B1u + 0x9E3779B1u;
  x ^= x >> 15;
  x *= 0x85EBCA77u;
  return x ^ (x >> 13);
}

// The rare path: a warp with a loose hit in some lane's run appends every
// lane's hits below n as codes, at one atomicAdd for the warp. The run's
// hashes go to a local array that only this path touches, so the common
// path keeps them in registers.
__device__ __forceinline__ void append(const uint32_t (&h)[kRun], int64_t p, int64_t n,
                                       uint32_t lim_s, uint32_t lim_l, int lane,
                                       int32_t* __restrict__ out) {
  uint32_t hits = 0, keep[kRun];
#pragma unroll
  for (int i = 0; i < kRun; ++i) {
    hits |= (uint32_t)(h[i] <= lim_l) << i;
    keep[i] = h[i];
  }
  if (p + kRun > n) hits &= p < n ? (1u << (int)(n - p)) - 1u : 0u;
  const int cnt = __popc(hits);
  int incl = cnt;  // inclusive prefix of the counts over the lanes
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const int t = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += t;
  }
  int base = 0;
  if (lane == 31) base = atomicAdd(out, incl);
  int32_t* dst = out + 1 + __shfl_sync(kFull, base, 31) + incl - cnt;
  while (hits) {
    const int i = __ffs(hits) - 1;
    hits &= hits - 1u;
    *dst++ = (int32_t)(((p + i) << 2) | 2 | (keep[i] <= lim_s));
  }
}

__global__ void __launch_bounds__(kThreads)
gear_candidates_kernel(const uint8_t* __restrict__ buf, int64_t n, int hist, int64_t span,
                       uint32_t mask_s, uint32_t mask_l, int32_t* __restrict__ out) {
  // The gear map as a table, one copy a bank: gear(b) at [b * 32 + lane],
  // so a warp's 32 lookups of any bytes hit 32 banks. Warp k maps bytes
  // 32k .. 32k + 31 and writes them lane by lane, conflict-free.
  __shared__ uint32_t table[256 * 32];
  const int lane = threadIdx.x & 31;
  {
    const uint32_t mine = gear((threadIdx.x & ~31) + lane);
#pragma unroll 4
    for (int j = 0; j < 32; ++j) {
      table[((threadIdx.x & ~31) + j) * 32 + lane] = __shfl_sync(kFull, mine, j);
    }
  }
  __syncthreads();
  const uint32_t* row = table + lane;
  const int64_t first = ((int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5)) * span * kStep;
  if (first >= n) return;  // the whole warp
  const int64_t end = first + span * kStep < n ? first + span * kStep : n;
  const uint32_t lim_s = ~mask_s, lim_l = ~mask_l;

  // The hash at position first - 1: byte first - 32 + lane, shifted by
  // 31 - lane, summed over the warp. Only the blob's first span reaches
  // buffer bytes before the real history.
  const int64_t at = kLead + first - kWindow + lane;
  uint32_t g = gear(buf[at]);
  if (first == 0 && at < kLead - hist) g = 0u;
  uint32_t carry = __reduce_add_sync(kFull, g << (31 - lane));

  // Each step's 32 bytes a lane are loaded one step ahead.
  const uint4* src = reinterpret_cast<const uint4*>(buf + kLead + first) + 2 * lane;
  uint4 a = __ldg(src), b = __ldg(src + 1);
#pragma unroll 1
  for (int64_t p0 = first; p0 < end; p0 += kStep) {
    const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    src += kStep / 16;
    if (p0 + kStep < end) {
      a = __ldg(src);
      b = __ldg(src + 1);
    }
    uint32_t h[kRun];
    uint32_t l = 0u;
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      l = (l << 1) + row[__byte_perm(w[i / 4], 0u, 0x4440u + (i % 4)) * 32];
      h[i] = l;
    }
    uint32_t prev = __shfl_up_sync(kFull, l, 1);
    if (lane == 0) prev = carry;
    carry = __shfl_sync(kFull, l, 31);
    uint32_t lo = l;  // h_31 = L_31: the shift pushed P out
#pragma unroll
    for (int i = 0; i < kRun - 1; ++i) {
      h[i] += prev << (i + 1);
      lo = min(lo, h[i]);
    }
    if (__any_sync(kFull, lo <= lim_l)) {
      append(h, p0 + (int64_t)lane * kRun, n, lim_s, lim_l, lane, out);
    }
  }
}

// Blocks that fill the card once: the SM count times the kernel's
// resident blocks an SM (cached a device).
int card_blocks() {
  static int cached[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 0;
  if (cached[dev] == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gear_candidates_kernel, kThreads, 0);
    cached[dev] = sms * per_sm;
  }
  return cached[dev];
}

}  // namespace

extern "C" {

// Launches the kernel on ``stream`` for a window of n positions (layout
// above), after zeroing the count out[0] on the same stream: one wave of
// blocks that fills the card, each warp a contiguous span of whole steps.
// Returns cudaGetLastError(): 0 when both were accepted.
int gear_candidates_launch(const void* buf, int64_t n, int hist, uint32_t mask_s,
                           uint32_t mask_l, void* out, void* stream) {
  cudaMemsetAsync(out, 0, sizeof(int32_t), (cudaStream_t)stream);
  const int64_t warps = (int64_t)card_blocks() * kWarps;
  if (n > 0 && warps == 0) return (int)cudaErrorInvalidConfiguration;
  if (n > 0) {
    const int64_t steps = (n + kStep - 1) / kStep;
    const int64_t span = (steps + warps - 1) / warps;
    const int64_t blocks = ((steps + span - 1) / span + kWarps - 1) / kWarps;
    gear_candidates_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)buf, n, hist, span, mask_s, mask_l, (int32_t*)out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
