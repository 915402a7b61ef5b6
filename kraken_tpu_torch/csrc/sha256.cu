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

namespace {

__constant__ uint32_t kK[64] = {
    0x428a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu, 0x59f111f1u,
    0x923f82a4u, 0xab1c5ed5u, 0xd807aa98u, 0x12835b01u, 0x243185beu, 0x550c7dc3u,
    0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u, 0xc19bf174u, 0xe49b69c1u, 0xefbe4786u,
    0x0fc19dc6u, 0x240ca1ccu, 0x2de92c6fu, 0x4a7484aau, 0x5cb0a9dcu, 0x76f988dau,
    0x983e5152u, 0xa831c66du, 0xb00327c8u, 0xbf597fc7u, 0xc6e00bf3u, 0xd5a79147u,
    0x06ca6351u, 0x14292967u, 0x27b70a85u, 0x2e1b2138u, 0x4d2c6dfcu, 0x53380d13u,
    0x650a7354u, 0x766a0abbu, 0x81c2c92eu, 0x92722c85u, 0xa2bfe8a1u, 0xa81a664bu,
    0xc24b8b70u, 0xc76c51a3u, 0xd192e819u, 0xd6990624u, 0xf40e3585u, 0x106aa070u,
    0x19a4c116u, 0x1e376c08u, 0x2748774cu, 0x34b0bcb5u, 0x391c0cb3u, 0x4ed8aa4au,
    0x5b9cca4fu, 0x682e6ff3u, 0x748f82eeu, 0x78a5636fu, 0x84c87814u, 0x8cc70208u,
    0x90befffau, 0xa4506cebu, 0xbef9a3f7u, 0xc67178f2u,
};

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

// Little-endian load -> big-endian SHA word.
__device__ __forceinline__ uint32_t bswap(uint32_t x) {
  return __byte_perm(x, 0, 0x0123);
}

// One compression of the block in w[16] into st[8]. Fully unrolled: every
// index into w is a constant, so w stays in registers.
__device__ __forceinline__ void compress(uint32_t st[8], uint32_t w[16]) {
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    if (i >= 16) {
      const uint32_t w15 = w[(i + 1) & 15], w2 = w[(i + 14) & 15];
      const uint32_t s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3);
      const uint32_t s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10);
      w[i & 15] += s0 + w[(i + 9) & 15] + s1;
    }
    const uint32_t t1 = h + (rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)) +
                        (g ^ (e & (f ^ g))) + kK[i] + w[i & 15];
    const uint32_t t2 =
        (rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22)) + ((a & (b ^ c)) ^ (b & c));
    h = g; g = f; f = e; e = d + t1;
    d = c; c = b; b = a; a = t1 + t2;
  }
  st[0] += a; st[1] += b; st[2] += c; st[3] += d;
  st[4] += e; st[5] += f; st[6] += g; st[7] += h;
}

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

  uint32_t st[8] = {0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u, 0xa54ff53au,
                    0x510e527fu, 0x9b05688cu, 0x1f83d9abu, 0x5be0cd19u};
  uint32_t w[16];

  if (((uintptr_t)p & 15) == 0) {
    // 16-byte aligned row (the ragged staging buffer aligns every start):
    // four 128-bit loads per block.
    const uint4* q = reinterpret_cast<const uint4*>(p);
    for (uint64_t blk = 0; blk < nfull; ++blk, q += 4) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint4 v = __ldg(q + k);
        w[4 * k + 0] = bswap(v.x);
        w[4 * k + 1] = bswap(v.y);
        w[4 * k + 2] = bswap(v.z);
        w[4 * k + 3] = bswap(v.w);
      }
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
