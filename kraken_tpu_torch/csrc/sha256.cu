// SHA-256 of many byte rows on Hopper (sm_90a): one thread hashes one row.
//
// Replaces two TPU functions of kraken_tpu:
//   - ops/sha256_pallas.py sha256_tiles (the Pallas kernel _make_kernel,
//     packed=False): equal-length pieces from the natural byte layout, the
//     origin's metainfo generation;
//   - ops/sha256.py _sha256_ragged (XLA lax.scan of _compress): rows of any
//     length, each stopping at its own block count, the agent's verify.
//
// What bounds it: SHA-256 is integer work, ~1,400 32-bit ALU operations
// (rotates, three-input logic, three-input adds) per 64-byte block, against
// 64 bytes read from memory. By the data sheet, 132 SMs x 64 INT32 lanes at
// 1.98 GHz issue ~16.7 T ops/s, an input rate of ~765 GB/s, against
// 3.35 TB/s of memory bandwidth: operations bound it, not bytes. Measured
// on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md, chip_sha256_sweep.py):
// 739 GB/s with 135,168 rows of 64 KiB in flight, 97 % of that bound; but
// 1.8 GB/s for the main path's 64-row launches, which run one piece's
// serial chain on one SM.
//
// What the design does about it: parallelism is across rows, as on the TPU
// (a row's blocks form a dependency chain). Each thread keeps its state and
// a 16-word schedule ring in registers; the 64 rounds are unrolled so the
// ring indices and the round constants are compile-time (K sits in
// __constant__ and folds into the instructions); rotations are
// __funnelshift_r; the SHA padding (tail bytes, 0x80, bit length) is built
// in registers after the last full block, so the host never pads. This
// first version does not coalesce its loads (neighbouring threads read
// rows a piece length apart) and fills only ceil(N/128) blocks of 128
// threads: filling the card is the callers' batch size.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sha256_common.cuh"

namespace {

__global__ void __launch_bounds__(128)
sha256_rows_kernel(const uint8_t* __restrict__ flat,
                   const int64_t* __restrict__ offsets,
                   const int64_t* __restrict__ lengths, int64_t n,
                   int32_t* __restrict__ out) {
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const uint8_t* p = flat + offsets[row];
  const uint64_t len = (uint64_t)lengths[row];
  const uint64_t nfull = len >> 6;

  uint32_t st[8];
  sha256_init(st);
  uint32_t w[16];

  if (((uintptr_t)p & 15) == 0) {
    // 16-byte aligned row (the ragged staging buffer aligns every start):
    // four 128-bit loads per block.
    const uint4* q = reinterpret_cast<const uint4*>(p);
    for (uint64_t blk = 0; blk < nfull; ++blk, q += 4) {
      load_block_aligned(q, w);
      compress(st, w);
    }
  } else if (((uintptr_t)p & 3) == 0) {
    const uint32_t* q = reinterpret_cast<const uint32_t*>(p);
    for (uint64_t blk = 0; blk < nfull; ++blk, q += 16) {
#pragma unroll
      for (int k = 0; k < 16; ++k) w[k] = bswap(__ldg(q + k));
      compress(st, w);
    }
  } else {
    const uint8_t* q = p;
    for (uint64_t blk = 0; blk < nfull; ++blk, q += 64) {
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        w[k] = ((uint32_t)q[4 * k] << 24) | ((uint32_t)q[4 * k + 1] << 16) |
               ((uint32_t)q[4 * k + 2] << 8) | (uint32_t)q[4 * k + 3];
      }
      compress(st, w);
    }
  }

  // Final block(s): the rem tail bytes, 0x80, zeros, and the 64-bit bit
  // length in the last 8 bytes -- a second block when rem >= 56.
  const uint8_t* tail = p + (nfull << 6);
  const uint32_t rem = (uint32_t)(len & 63);
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    uint32_t v = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t pos = 4 * k + j;
      const uint32_t byte = pos < rem ? tail[pos] : (pos == rem ? 0x80u : 0u);
      v = (v << 8) | byte;
    }
    w[k] = v;
  }
  if (rem >= 56) {
    compress(st, w);
#pragma unroll
    for (int k = 0; k < 16; ++k) w[k] = 0;
  }
  const uint64_t bits = len << 3;
  w[14] = (uint32_t)(bits >> 32);
  w[15] = (uint32_t)bits;
  compress(st, w);

#pragma unroll
  for (int k = 0; k < 8; ++k) out[row * 8 + k] = (int32_t)st[k];
}

}  // namespace

extern "C" {

// Launches the kernel on ``stream`` for n rows. Returns cudaGetLastError():
// 0 when the launch was accepted.
int sha256_rows_launch(const void* flat, const void* offsets,
                       const void* lengths, int64_t n, void* out,
                       void* stream) {
  if (n > 0) {
    const int threads = 128;
    const int64_t blocks = (n + threads - 1) / threads;
    sha256_rows_kernel<<<(unsigned)blocks, threads, 0,
                         (cudaStream_t)stream>>>(
        (const uint8_t*)flat, (const int64_t*)offsets,
        (const int64_t*)lengths, n, (int32_t*)out);
  }
  return (int)cudaGetLastError();
}

const char* sha256_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
