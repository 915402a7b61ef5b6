// The relayout diagnostic on Hopper (sm_90a): two kernels of one function.
//
// The function: for each piece of a [M, P] uint8 batch (M % 1024 == 0,
// P % 512 == 0, rows 16-byte aligned), the XOR of its big-endian 32-bit
// words by word index mod 8 -- every 32-byte line folded into 8 words --
// written as [M / 1024, 8, 8, 128] words: word i of piece
// t * 1024 + s * 128 + l at [t, i, s, l]. The fold is there so the loads
// cannot be dropped as dead code. kraken_tpu_torch.bench.transpose times
// both kernels beside the natural and the packed hash.
//
// What bounds both: bytes. The function reads P bytes and writes 32 per
// piece, with two integer operations a word (a byte swap and a XOR), 0.5 a
// byte against the ~22 a byte of SHA-256: at 1024 x 256 KiB the bound is
// 268.5 MB over 3.35 TB/s = 0.080 ms, at 132 x 1024 x 64 KiB 2.646 ms.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sha256_common.cuh"

namespace {

constexpr int64_t kTile = 1024;  // pieces per output tile

// -- transpose_only_kernel: the fold at the card's memory rate --------------
//
// Replaces the TPU function bench_transpose.py transpose_only (its Pallas
// kernel transpose_only_kernel, bench_transpose.py:53): on the TPU it was
// the u8 -> word relayout the natural Pallas kernel does before its
// rounds. On this card it is the function done as fast as its bytes allow.
//
// What the design does about its bound:
// - It fills the card. Each piece is cut into segments of kSegBytes
//   (16 KiB; the last one of a piece is shorter when P is not a whole
//   number of segments, the edge segment). Blocks of kFoldThreads walk the
//   (piece, segment) items grid-stride, one wave of blocks resident on
//   every SM. At 16 KiB the JAX bench's 1024 x 256 KiB is 16,384 items,
//   ~16 a block at the 8 blocks an SM that 32 registers allow, so the
//   last wave's stragglers are a small share; and its 4 loads a thread
//   keep 128 KiB in flight an SM, over the ~25 KB that 3.35 TB/s needs at
//   HBM's latency. On an H100 SXM (700 W), chip_transpose_sweep.py timed
//   8 KiB segments ~1 % slower at both shapes, and 32 KiB level with 16
//   at 48 registers a thread.
// - It coalesces. In a segment thread t reads 16-byte vectors t, t + 256,
//   t + 512, t + 768: a warp reads 512 contiguous bytes a load. A 32-byte
//   line is two vectors and the stride is even, so a thread's vectors all
//   hold words 0-3 (t even) or all words 4-7 (t odd) of their lines, and
//   one uint4 accumulator is enough.
// - It keeps bytes in flight: the 4 loads are issued before the XORs use
//   them, read-only and streaming (ld.global.nc, L1 no-allocate): every
//   byte is read once, and 256 MiB and 8.25 GiB both exceed the 50 MB L2.
// - It byte-swaps once: the raw little-endian words are folded, and the 8
//   results swapped at the end (XOR commutes with the byte swap).
// - It reduces exactly: XOR shuffles among lanes of one parity (offsets 2,
//   4, 8, 16), then across the 8 warps through shared memory (two buffers,
//   so one barrier an item), then one atomicXor a word a segment into the
//   output, which the launch zeroes first on the same stream. XOR is
//   associative and commutative, so the result is bit-exact in any order.

constexpr int kFoldThreads = 256;
constexpr int kFoldWarps = kFoldThreads / 32;
constexpr int64_t kSegBytes = 16 * 1024;
constexpr int kSegVecs = (int)(kSegBytes / 16);
constexpr int kLoads = kSegVecs / kFoldThreads;  // 16-byte loads a thread a segment
static_assert(kLoads * kFoldThreads == kSegVecs, "a segment is whole loads");

// 16 bytes, read-only, not kept in L1, with a 256-byte L2 prefetch: each
// byte is read once.
__device__ __forceinline__ uint4 load_stream(const uint4* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

__global__ void __launch_bounds__(kFoldThreads)
transpose_only_kernel(const uint8_t* __restrict__ rows, int64_t m,
                      int64_t piece_len, int64_t segs,
                      uint32_t* __restrict__ out) {
  __shared__ uint32_t red[2][kFoldWarps][8];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t items = m * segs;
  int buf = 0;
  for (int64_t item = blockIdx.x; item < items; item += gridDim.x, buf ^= 1) {
    const int64_t piece = item / segs, seg = item - piece * segs;
    const int64_t start = seg * kSegBytes;
    const int64_t len = piece_len - start < kSegBytes ? piece_len - start : kSegBytes;
    const int nvec = (int)(len >> 4);  // a multiple of 32: P % 512 == 0
    const uint4* base = reinterpret_cast<const uint4*>(rows + piece * piece_len + start);

    uint4 v[kLoads];
    if (nvec == kSegVecs) {
#pragma unroll
      for (int k = 0; k < kLoads; ++k) v[k] = load_stream(base + tid + k * kFoldThreads);
    } else {
      // The edge segment: fewer vectors than threads x loads.
#pragma unroll
      for (int k = 0; k < kLoads; ++k) {
        const int idx = tid + k * kFoldThreads;
        v[k] = idx < nvec ? load_stream(base + idx) : make_uint4(0, 0, 0, 0);
      }
    }
    uint4 a = v[0];
#pragma unroll
    for (int k = 1; k < kLoads; ++k) {
      a.x ^= v[k].x; a.y ^= v[k].y; a.z ^= v[k].z; a.w ^= v[k].w;
    }
#pragma unroll
    for (int off = 2; off < 32; off <<= 1) {
      a.x ^= __shfl_xor_sync(0xffffffffu, a.x, off);
      a.y ^= __shfl_xor_sync(0xffffffffu, a.y, off);
      a.z ^= __shfl_xor_sync(0xffffffffu, a.z, off);
      a.w ^= __shfl_xor_sync(0xffffffffu, a.w, off);
    }
    if (lane < 2) {  // lane 0: words 0-3 of the warp's lines, lane 1: 4-7
      uint32_t* r = red[buf][warp] + 4 * lane;
      r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w;
    }
    __syncthreads();
    if (tid < 8) {
      uint32_t x = 0;
#pragma unroll
      for (int w = 0; w < kFoldWarps; ++w) x ^= red[buf][w][tid];
      atomicXor(out + (piece / kTile) * 8 * kTile + tid * kTile + piece % kTile, bswap(x));
    }
  }
}

// Blocks that fill the card once: the SM count times the fold's resident
// blocks an SM (cached a device).
int fold_blocks() {
  static int cached[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 0;
  if (cached[dev] == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, transpose_only_kernel, kFoldThreads, 0);
    cached[dev] = sms * per_sm;
  }
  return cached[dev];
}

// -- natural_loads_kernel: the gap decomposition's loads leg ----------------
//
// Replaces no TPU kernel. It is the loads leg of
// kraken_tpu_torch.bench.transpose.decompose: the natural SHA-256 kernel's
// own loads, with XOR folds where that kernel compresses, so that its time
// beside the packed rounds' splits the natural kernel's time into loads
// and rounds. It computes the same function as transpose_only_kernel.
//
// Its access is sha256_rows_kernel's aligned path (csrc/sha256.cu): one
// thread a piece, 128 threads a block; the kRing block ring of
// sha256_common.cuh, each 64-byte block copied into shared memory by four
// cp.async 16-byte copies two blocks ahead, committed and waited for
// (wait_group 1) in the same order; each word byte-swapped as it leaves
// the ring; then the 16 words XOR-folded into 8 accumulators where the
// natural kernel calls compress. It must follow sha256_rows_kernel
// whenever a later change moves that kernel's loads.
//
// What bounds it: bytes, like the fold; but at 1024 pieces its 8 blocks
// sit on 8 of the 132 SMs with two 64-byte blocks a thread in flight, so
// it reads at what 8 SMs' rings can pull, far under 3.35 TB/s. That is the
// point: it is the natural kernel's load rate, not the card's.

constexpr int kNaturalThreads = 128;  // as sha256_rows_launch

__global__ void __launch_bounds__(kNaturalThreads)
natural_loads_kernel(const uint8_t* __restrict__ rows, int64_t m,
                     int64_t piece_len, uint32_t* __restrict__ out) {
  const int64_t piece = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (piece >= m) return;
  const uint4* q = reinterpret_cast<const uint4*>(rows + piece * piece_len);
  const int64_t nfull = piece_len >> 6;

  uint32_t acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0;
  uint32_t w[16];
  __shared__ uint4 ring[kRing][4][kNaturalThreads];
  const int tid = threadIdx.x;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    if (s < nfull) {
#pragma unroll
      for (int k = 0; k < 4; ++k) cp_async16(&ring[s][k][tid], q + 4 * s + k);
    }
    cp_async_commit();
  }
  q += 8;
  int cur = 0, ahead = 2;
  for (int64_t blk = 0; blk < nfull; ++blk) {
    cp_async_wait_all_but_newest();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint4 v = ring[cur][k][tid];
      w[4 * k + 0] = bswap(v.x);
      w[4 * k + 1] = bswap(v.y);
      w[4 * k + 2] = bswap(v.z);
      w[4 * k + 3] = bswap(v.w);
    }
    if (blk + 2 < nfull) {
#pragma unroll
      for (int k = 0; k < 4; ++k) cp_async16(&ring[ahead][k][tid], q + k);
    }
    cp_async_commit();
    q += 4;
    cur = next_slot(cur);
    ahead = next_slot(ahead);
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[j & 7] ^= w[j];
  }

  // Word-major, so neighbouring threads write neighbouring addresses.
  uint32_t* dst = out + (piece / kTile) * 8 * kTile + piece % kTile;
#pragma unroll
  for (int i = 0; i < 8; ++i) dst[i * kTile] = acc[i];
}

}  // namespace

extern "C" {

// Launches transpose_only_kernel on ``stream``: ``rows`` (m x piece_len
// bytes, 16-byte aligned, m % 1024 == 0, piece_len % 512 == 0) -> ``out``
// ([m / 1024, 8, 1024] words), zeroed first on the same stream for the
// kernel's atomicXor. Returns the memset's error or cudaGetLastError():
// 0 when both were accepted.
int transpose_only_launch(const void* rows, int64_t m, int64_t piece_len,
                          void* out, void* stream) {
  if (m > 0) {
    const cudaError_t e = cudaMemsetAsync(out, 0, (size_t)m * 8 * sizeof(uint32_t),
                                          (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
    const int64_t segs = (piece_len + kSegBytes - 1) / kSegBytes;
    const int64_t card = fold_blocks();
    if (card == 0) return (int)cudaErrorInvalidConfiguration;
    const int64_t blocks = m * segs < card ? m * segs : card;
    transpose_only_kernel<<<(unsigned)blocks, kFoldThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)rows, m, piece_len, segs, (uint32_t*)out);
  }
  return (int)cudaGetLastError();
}

// Launches natural_loads_kernel on ``stream``, with the same arguments and
// output as transpose_only_launch, one thread a piece as
// sha256_rows_launch. Returns cudaGetLastError(): 0 when the launch was
// accepted.
int natural_loads_launch(const void* rows, int64_t m, int64_t piece_len,
                         void* out, void* stream) {
  if (m > 0) {
    const int64_t blocks = (m + kNaturalThreads - 1) / kNaturalThreads;
    natural_loads_kernel<<<(unsigned)blocks, kNaturalThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)rows, m, piece_len, (uint32_t*)out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
