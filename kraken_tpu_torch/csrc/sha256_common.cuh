// SHA-256 compression shared by the kernels of csrc/sha256.cu and
// csrc/sha256_packed.cu: the round constants, the initial state, the block
// ring that takes the block load out of a row's chain, and one unrolled
// compression with a 16-word schedule ring in registers. The relayout
// diagnostic's loads leg (csrc/transpose.cu, natural_loads_kernel) uses
// the ring as sha256_rows_kernel does.
//
// The compression needs 1,024 ALU-pipe operations a block (64 rounds of 6
// funnel-shift rotates and 4 three-input logic ops, 48 schedule steps of 6
// shifts and 2 logic ops) and 360 adds that may go to the ALU or the FMA
// pipe; one warp's chain of rounds alone is 640 ALU-pipe operations, at
// least 1,280 clocks a block (chip_smoke.py, SHA_ROUNDS). As built it is
// ~1,290 ALU-pipe SASS instructions a block, most two-input adds going to
// the FMA pipe as IMAD. Moving more adds, shifts or rotates to the FMA pipe
// by hand (IMAD, IMAD.HI with multipliers the compiler cannot see) did not
// shorten the main path's chain; summing h + K[i] + W[i] apart did.
//
// Each .cu file is its own translation unit (no relocatable device code),
// so everything here has internal linkage and each kernel gets its own
// copy of the constants.

#pragma once

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

// The initial hash state H0.
__device__ __forceinline__ void sha256_init(uint32_t st[8]) {
  st[0] = 0x6a09e667u; st[1] = 0xbb67ae85u; st[2] = 0x3c6ef372u;
  st[3] = 0xa54ff53au; st[4] = 0x510e527fu; st[5] = 0x9b05688cu;
  st[6] = 0x1f83d9abu; st[7] = 0x5be0cd19u;
}

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

// Little-endian load -> big-endian SHA word.
__device__ __forceinline__ uint32_t bswap(uint32_t x) {
  return __byte_perm(x, 0, 0x0123);
}

// Asynchronous copies from device memory into shared memory (cp.async),
// for the block ring below: one 16-byte or 4-byte copy; commit_group closes
// a thread's batch of copies, and wait_group 1 waits until at most the
// newest batch is still in flight.
__device__ __forceinline__ void cp_async16(uint4* smem, const void* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t* smem, const void* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// The SHA kernels' block ring: kRing 64-byte slots a thread in shared
// memory, 16-byte word k of slot s of thread tid at [s][k][tid] (a warp's
// reads of one k are 512 contiguous bytes). Block i is copied in while
// block i - 2 is hashed, and read from slot i % kRing after a
// wait_group 1. The compiler may issue a block's copies anywhere in the
// loop body (ptxas places them after the rounds, as it does loads into a
// register buffer), and a whole compression still lies between them and
// the wait before their block. 24 KiB a block of 128 threads.
constexpr int kRing = 3;

__device__ __forceinline__ int next_slot(int s) { return s == kRing - 1 ? 0 : s + 1; }

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
    // h + K[i] + W[i] does not depend on this round's e: summed apart, it
    // leaves e's chain two adds after Sigma1 and Ch.
    const uint32_t pre = h + kK[i] + w[i & 15];
    const uint32_t t1 = pre + (rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)) + (g ^ (e & (f ^ g)));
    const uint32_t t2 =
        (rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22)) + ((a & (b ^ c)) ^ (b & c));
    h = g; g = f; f = e; e = d + t1;
    d = c; c = b; b = a; a = t1 + t2;
  }
  st[0] += a; st[1] += b; st[2] += c; st[3] += d;
  st[4] += e; st[5] += f; st[6] += g; st[7] += h;
}

}  // namespace
