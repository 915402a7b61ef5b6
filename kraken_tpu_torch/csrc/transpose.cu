// The relayout diagnostic on Hopper (sm_90a): the natural SHA-256 kernel's
// loads and byte swaps, with no rounds.
//
// Replaces the TPU function bench_transpose.py transpose_only (the Pallas
// kernel transpose_only_kernel): for each piece of a [M, P] uint8 batch
// (M % 1024 == 0, P % 512 == 0), the XOR of its big-endian 32-bit words by
// word index mod 8 -- every 32-byte line folded into 8 words -- written as
// [M / 1024, 8, 8, 128] words: word i of piece t * 1024 + s * 128 + l at
// [t, i, s, l]. The fold is there so the loads cannot be dropped as dead
// code. On the TPU it measured the u8 -> word relayout the natural Pallas
// kernel does before its rounds; kraken_tpu_torch.bench.transpose times
// it beside the natural and the packed hash to split the natural kernel's
// time into its loads and its rounds.
//
// What bounds it: bytes. It reads P bytes and writes 32 per piece, with two
// integer operations a word (a byte swap and a XOR), 0.5 a byte against
// the ~22 a byte of SHA-256: at 1024 x 256 KiB the bound is 268.5 MB over
// 3.35 TB/s = 0.080 ms.
//
// What the design does: it is the natural kernel's access pattern on
// purpose, not a fast fold. On the H100 the natural kernel does no
// relayout: a thread owns a piece and reads its rows 16 bytes at a time,
// neighbouring threads a piece length apart (uncoalesced: each load uses
// 16 of a 32-byte sector). So this kernel runs one thread per piece, 128
// threads a block, as sha256_rows_launch does; loads each 64-byte block
// through the same load_block_aligned (sha256_common.cuh); XORs the 16
// words into 8 register accumulators; and keeps the block loop rolled
// (#pragma unroll 1), as the natural kernel's loop is around its unrolled
// compression, so the compiler cannot batch more loads in flight than the
// natural kernel has. The 8 words are stored word-major, so neighbouring
// threads write neighbouring addresses.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sha256_common.cuh"

namespace {

constexpr int64_t kTile = 1024;  // pieces per output tile

__global__ void __launch_bounds__(128)
transpose_only_kernel(const uint8_t* __restrict__ rows, int64_t m,
                      int64_t piece_len, uint32_t* __restrict__ out) {
  const int64_t piece = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (piece >= m) return;
  const uint4* q = reinterpret_cast<const uint4*>(rows + piece * piece_len);
  const int64_t nb = piece_len >> 6;

  uint32_t acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0;
  uint32_t w[16];
#pragma unroll 1
  for (int64_t blk = 0; blk < nb; ++blk, q += 4) {
    load_block_aligned(q, w);
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[j & 7] ^= w[j];
  }

  uint32_t* dst = out + (piece / kTile) * 8 * kTile + piece % kTile;
#pragma unroll
  for (int i = 0; i < 8; ++i) dst[i * kTile] = acc[i];
}

}  // namespace

extern "C" {

// Launches transpose_only_kernel on ``stream``: ``rows`` (m x piece_len
// bytes, 16-byte aligned, m % 1024 == 0, piece_len % 64 == 0) -> ``out``
// ([m / 1024, 8, 1024] words). Returns cudaGetLastError(): 0 when the
// launch was accepted.
int transpose_only_launch(const void* rows, int64_t m, int64_t piece_len,
                          void* out, void* stream) {
  if (m > 0) {
    const int threads = 128;
    const int64_t blocks = (m + threads - 1) / threads;
    transpose_only_kernel<<<(unsigned)blocks, threads, 0,
                            (cudaStream_t)stream>>>(
        (const uint8_t*)rows, m, piece_len, (uint32_t*)out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
