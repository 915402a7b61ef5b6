// SHA-256 of many byte rows on Hopper (sm_90a): one thread hashes one row.
//
// Replaces two TPU functions of kraken_tpu:
//   - ops/sha256_pallas.py sha256_tiles (the Pallas kernel _make_kernel,
//     packed=False): equal-length pieces from the natural byte layout, the
//     origin's metainfo generation;
//   - ops/sha256.py _sha256_ragged (XLA lax.scan of _compress): rows of any
//     length, each stopping at its own block count, the agent's verify.
//
// What bounds it, by regime. SHA-256 needs, a 64-byte block, 1,040
// operations that only the integer ALU pipe runs (a round's 6 funnel-shift
// rotates and 4 three-input logic ops, a schedule step's 6 shifts and 2
// logic ops, 16 byte swaps) and 360 adds that run on the ALU pipe (IADD3)
// or the FMA pipe (IMAD); chip_smoke.py (SHA_ROUNDS) counts them. An SM's
// ALU pipe has 64 lanes, and a sub-partition's 16, so a warp instruction
// holds it 2 clocks:
//   - with every SM full (132 x 1024 rows of 64 KiB), the ALU pipe bounds
//     it: 1,040 / 64 clocks a block an SM, 8.61 ms for the 8.25 GiB; the
//     kernel takes ~11.6-11.9 ms;
//   - at the main path's launches (64 rows of 4 MiB: two warps, each alone
//     on its sub-partition), a row's chain of rounds bounds it (the
//     schedule can run on another warp): 2 x 640 clocks a block, 42.4 ms
//     for a row's 65,537 blocks; the kernel takes ~99 ms (~3,000 clocks a
//     block). Every launch of the origin and the agent is in this regime.
// Bytes bound neither: 64 bytes a block against 3.35 TB/s. As built, a
// block of the 16-byte aligned loop (the main path's) is 1,459 SASS
// instructions: ~1,293 on the ALU pipe, 127 on the FMA pipe (two-input
// adds as IMAD), ~39 others (shared-memory reads, async copies, the
// branch); chip_smoke.py reads them from cuobjdump -sass on every run. So
// one warp that runs both the schedule and the rounds needs at least
// 2 x ~1,293 clocks a block: the chain's gap to its bound is the schedule
// and the adds that ptxas leaves on the ALU pipe.
//
// What the design does about it: parallelism is across rows, as on the TPU
// (a row's blocks form a dependency chain). Each thread keeps its state and
// a 16-word schedule ring in registers; the 64 rounds are unrolled so the
// ring indices and the round constants are compile-time (K sits in
// __constant__ and folds into the instructions); rotations are
// __funnelshift_r; the SHA padding (tail bytes, 0x80, bit length) is built
// in registers after the last full block, so the host never pads. Two
// things shorten the chain (sha256_common.cuh):
//   - the block load leaves it: a thread copies block k + 2 of its row into
//     a ring in shared memory (cp.async) while block k is hashed. Loading
//     at the top of the loop exposed ~1,300 clocks of load latency a block
//     (4,530 clocks in all); a register double buffer hid little, because
//     ptxas issues those loads late in the loop to save registers;
//   - h + K[i] + W[i] is summed off e's dependency chain.
// Together they took the main shape from 150 ms to ~99 ms. The loads do
// not coalesce (neighbouring threads read rows a piece length apart), and
// a launch of N rows fills ceil(N / 128) SMs: filling the card is the
// callers' batch size. A second warp of each 32 rows computing their
// message schedule (the rounds warp then issues 776 ALU instructions a
// block) took the main shape to 67 ms but the full card 9 % slower; it is
// not used (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

#include "sha256_common.cuh"

namespace {

constexpr int kThreads = 128;  // threads a block

__global__ void __launch_bounds__(kThreads)
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
    // each block is four 16-byte copies.
    // The block ring of sha256_common.cuh, two blocks ahead. The copies
    // stop at the last full block; the tail below reads its bytes one by
    // one, so a row ending at its allocation's last byte is never read
    // past.
    __shared__ uint4 ring[kRing][4][kThreads];
    const int tid = threadIdx.x;
    const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      if ((uint64_t)s < nfull) {
#pragma unroll
        for (int k = 0; k < 4; ++k) cp_async16(&ring[s][k][tid], q + 4 * s + k);
      }
      cp_async_commit();
    }
    q += 8;
    int cur = 0, ahead = 2;
    for (uint64_t blk = 0; blk < nfull; ++blk) {
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
    const int64_t blocks = (n + kThreads - 1) / kThreads;
    sha256_rows_kernel<<<(unsigned)blocks, kThreads, 0,
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
