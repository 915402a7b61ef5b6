// The packed path on Hopper (sm_90a): the relayout of natural piece bytes
// into word-major tiles, and SHA-256 over those tiles.
//
// Replaces two TPU functions of kraken_tpu (ops/sha256_pallas.py):
//   - pack_tiles_device (the Pallas kernel _make_pack_kernel): natural
//     [M, P] uint8 pieces -> the packed [T, NB, 16, 8, 128] big-endian
//     words, the on-device pack of the ingest plane's `pack_mode: device`;
//   - sha256_packed_tiles (the Pallas kernel _make_kernel, packed=True):
//     SHA-256 of the T * 1024 pieces of such tiles, the hash of the ingest
//     plane's `pack_mode: device` and `native` windows.
//
// The layout is the TPU's, bit for bit: word j of block kb of piece
// t * 1024 + lane sits at word ((t * NB + kb) * 16 + j) * 1024 + lane, so a
// window packed by either host packer (kraken_tpu/native, kraken_tpu_torch/
// native) hashes here unchanged. On this card the layout coalesces: word j
// of 32 neighbouring pieces is one contiguous 128-byte line.
//
// sha256_packed_kernel -- what bounds it: as sha256_rows_kernel
// (csrc/sha256.cu), integer issue, by regime, with no byte swaps: 1,024
// ALU-only operations and 360 adds a block. With every SM full the ALU
// pipe bounds it (8.48 ms at 132 x 1024 pieces of 64 KiB; it takes
// ~11.5 ms); a 1024-piece tile runs on 8 SMs, one warp a sub-partition,
// where a piece's chain of rounds bounds it: 2 x 640 clocks a block,
// 42.4 ms for the 65,537 blocks of a 4 MiB piece (it takes ~98 ms). As
// built, a block of its loop is 1,472 SASS instructions: 1,287 on the ALU
// pipe, 138 on the FMA pipe, 47 others (chip_smoke.py reads them from
// cuobjdump -sass). What the design does: one thread per
// piece (a piece's blocks form a dependency chain), state and a 16-word
// schedule ring in registers, the unrolled compression of
// sha256_common.cuh; each block is sixteen 4-byte copies, one coalesced
// line per warp each, into the shared-memory ring two blocks ahead of the
// rounds, so no load latency is left in the chain (loading at the top of
// the loop cost ~1,800 clocks a block of 4,800); no byte swap; the padding
// block (0x80, zeros, the bit length of nb * 64 bytes -- the same for every
// piece) is built in registers after the last data block, and blocks
// nb..NB-1 are never read; digests are written in piece order. Like
// csrc/sha256.cu it fills T * 8 blocks of 128 threads: filling the card is
// the callers' batch size.
//
// pack_tiles_kernel -- what bounds it: bytes. It reads P bytes and writes
// NB * 64 bytes per piece, with no arithmetic beyond byte swaps. What the
// design does: one thread per (piece, block) writes that block's 16 output
// words; neighbouring threads own neighbouring pieces, so each of the 16
// stores of a warp is one contiguous 128-byte line, and each thread reads
// its block's 64 contiguous bytes as four 16-byte loads (a warp reads 32
// whole 64-byte segments, a piece length apart: no sector is fetched for
// less than all of its bytes). Blocks nb..NB-1 are written as zeros, so
// the output needs no clearing. A shared-memory transpose or TMA staging
// would make the reads contiguous too; that is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sha256_common.cuh"

namespace {

constexpr int64_t kTile = 1024;  // pieces per packed tile
constexpr int kThreads = 128;    // threads a block

__global__ void __launch_bounds__(kThreads)
sha256_packed_kernel(const uint32_t* __restrict__ packed, int64_t n_pieces,
                     int64_t nb_out, int64_t nb, int32_t* __restrict__ out) {
  const int64_t piece = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (piece >= n_pieces) return;
  const int64_t t = piece / kTile;
  const uint32_t* p = packed + t * nb_out * 16 * kTile + piece % kTile;

  uint32_t st[8];
  sha256_init(st);
  // The block ring of sha256_common.cuh, two blocks ahead, word j of a
  // block at word j % 4 of [slot][j / 4][tid]. Blocks nb..NB-1 are never
  // read.
  __shared__ uint4 ring[kRing][4][kThreads];
  const int tid = threadIdx.x;
  uint32_t w[16];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    if (s < nb) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        cp_async4(reinterpret_cast<uint32_t*>(&ring[s][j / 4][tid]) + j % 4,
                  p + (16 * s + j) * kTile);
      }
    }
    cp_async_commit();
  }
  p += 32 * kTile;
  int cur = 0, ahead = 2;
  for (int64_t kb = 0; kb < nb; ++kb) {
    cp_async_wait_all_but_newest();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint4 v = ring[cur][k][tid];
      w[4 * k + 0] = v.x;
      w[4 * k + 1] = v.y;
      w[4 * k + 2] = v.z;
      w[4 * k + 3] = v.w;
    }
    if (kb + 2 < nb) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        cp_async4(reinterpret_cast<uint32_t*>(&ring[ahead][j / 4][tid]) + j % 4,
                  p + j * kTile);
      }
    }
    cp_async_commit();
    p += 16 * kTile;
    cur = next_slot(cur);
    ahead = next_slot(ahead);
    compress(st, w);
  }

  const uint64_t bits = (uint64_t)nb << 9;  // nb * 64 bytes * 8
  w[0] = 0x80000000u;
#pragma unroll
  for (int j = 1; j < 14; ++j) w[j] = 0;
  w[14] = (uint32_t)(bits >> 32);
  w[15] = (uint32_t)bits;
  compress(st, w);

#pragma unroll
  for (int k = 0; k < 8; ++k) out[piece * 8 + k] = (int32_t)st[k];
}

__global__ void __launch_bounds__(128)
pack_tiles_kernel(const uint8_t* __restrict__ rows, int64_t n_pieces,
                  int64_t piece_len, int64_t nb_out,
                  uint32_t* __restrict__ out) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_pieces * nb_out) return;
  const int64_t lane = idx % kTile;
  const int64_t kb = (idx / kTile) % nb_out;
  const int64_t t = idx / (kTile * nb_out);
  uint32_t* dst = out + (t * nb_out + kb) * 16 * kTile + lane;
  if (kb >= piece_len / 64) {
#pragma unroll
    for (int j = 0; j < 16; ++j) dst[j * kTile] = 0;
    return;
  }
  const uint4* src = reinterpret_cast<const uint4*>(
      rows + (t * kTile + lane) * piece_len + kb * 64);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint4 v = __ldg(src + k);
    dst[(4 * k + 0) * kTile] = bswap(v.x);
    dst[(4 * k + 1) * kTile] = bswap(v.y);
    dst[(4 * k + 2) * kTile] = bswap(v.z);
    dst[(4 * k + 3) * kTile] = bswap(v.w);
  }
}

}  // namespace

extern "C" {

// Launches sha256_packed_kernel on ``stream`` for the n_pieces (a multiple
// of 1024) pieces of ``packed`` ([n_pieces / 1024, nb_out, 16, 1024] words),
// hashing blocks 0..nb-1 of each. Returns cudaGetLastError(): 0 when the
// launch was accepted.
int sha256_packed_launch(const void* packed, int64_t n_pieces, int64_t nb_out,
                         int64_t nb, void* out, void* stream) {
  if (n_pieces > 0) {
    const int64_t blocks = (n_pieces + kThreads - 1) / kThreads;
    sha256_packed_kernel<<<(unsigned)blocks, kThreads, 0,
                           (cudaStream_t)stream>>>(
        (const uint32_t*)packed, n_pieces, nb_out, nb, (int32_t*)out);
  }
  return (int)cudaGetLastError();
}

// Launches pack_tiles_kernel on ``stream``: ``rows`` (n_pieces x piece_len
// bytes, 16-byte aligned, n_pieces % 1024 == 0, piece_len % 64 == 0) ->
// ``out`` ([n_pieces / 1024, nb_out, 16, 1024] words, every word written).
// Returns cudaGetLastError().
int pack_tiles_launch(const void* rows, int64_t n_pieces, int64_t piece_len,
                      int64_t nb_out, void* out, void* stream) {
  const int64_t n = n_pieces * nb_out;
  if (n > 0) {
    const int threads = 128;
    const int64_t blocks = (n + threads - 1) / threads;
    pack_tiles_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)rows, n_pieces, piece_len, nb_out, (uint32_t*)out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
