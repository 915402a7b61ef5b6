// FastCDC gear pass on Hopper (sm_90a): the 32-byte windowed gear hash at
// every byte position of a window, and its two mask tests.
//
// Replaces kraken_tpu/ops/cdc_pallas.py _gear_pallas (the Pallas kernel of
// _make_kernel): the gear map g(b), the windowed sum
// h_i = sum_{j=0..31} g(b_{i-j}) << j (mod 2^32), and the strict and loose
// tests (h & mask) == 0, with zero history in the gear domain before the
// blob's offset 0 (g(0) != 0, so zero bytes would not do).
//
// What bounds it: the least work is ~11 integer operations a byte (the
// gear map 6, one shift-add of the rolling form, two mask tests of 2)
// against 2 bytes moved (1 read, 1 mask byte written). By the data sheet,
// 132 SMs x 64 INT32 lanes at 1.98 GHz issue ~16.7 T ops/s, a ~1.5 TB/s
// input rate, against 3.35 TB/s of memory: 1.67 TB/s of input by bytes.
// The two are within 10 %: operations bound it by a hair, and a kernel
// that spends more than ~11 operations a byte is bound by its own issue
// rate. PERF.md has the time on the card beside this bound.
//
// What the design does about it: every byte's gear value is computed
// once. A block takes a tile of 4,096 positions: its threads read the tile
// and the 32 bytes before it as coalesced 4-byte words, map them to gear
// values in shared memory (zeroing those before the blob's offset 0), and
// then each thread rolls h = (h << 1) + g over the 31 values before its run
// of 16 positions and over the run itself -- after 32 steps the shift has
// pushed every older term out of the word, so h is the windowed sum. That
// is one shift-add a position, plus 31 / 16 for the warm-up, where the
// TPU's log-doubling took five. Shared memory holds one pad word every 16
// values, so the 32 runs of a warp read 32 different banks. Each thread
// writes its 16 mask bytes (bit 0 strict, bit 1 loose) as one 16-byte
// store. No atomics and no order between blocks: compacting the masks into
// candidate positions is left to the caller, on the device.
//
// Buffer layout (kraken_tpu_torch/ops/cdc_cuda.py): buf[kLead + p] is the
// window's byte p, for p < n; buf[kLead - hist .. kLead) is the real
// history before it (0 <= hist <= 31; 0 at the blob's offset 0); earlier
// bytes count as zero gear values. buf holds kLead + ceil(n / kTile) *
// kTile bytes and out ceil(n / kTile) * kTile: positions >= n are computed
// from whatever the padding holds and never read.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRun = 16;                   // positions a thread
constexpr int kTile = kThreads * kRun;     // positions a block
constexpr int kLead = 32;                  // buffer bytes before position 0
constexpr int kWindow = 32;                // bytes of history in the hash
constexpr int kValues = kLead + kTile;     // gear values a block maps
static_assert(kValues % 4 == 0 && kRun % 16 == 0, "layout");

// The arithmetic gear of kraken_tpu/ops/cdc.py _gear_fn_py (a murmur-style
// avalanche of b + 1); a framework constant of the on-disk chunk format.
__device__ __forceinline__ uint32_t gear(uint32_t b) {
  uint32_t x = (b + 1u) * 0x9E3779B1u;
  x ^= x >> 15;
  x *= 0x85EBCA77u;
  return x ^ (x >> 13);
}

// Shared-memory slot of gear value i: one pad word after every 16.
__device__ __forceinline__ int slot(int i) { return i + (i >> 4); }

__global__ void __launch_bounds__(kThreads)
gear_mask_kernel(const uint8_t* __restrict__ buf, int64_t n, int hist,
                 uint32_t mask_s, uint32_t mask_l, uint8_t* __restrict__ out) {
  __shared__ uint32_t g[kValues + kValues / 16];
  const int64_t tile0 = (int64_t)blockIdx.x * kTile;
  const uint32_t* src = reinterpret_cast<const uint32_t*>(buf + tile0);
  const int64_t first_real = kLead - hist;  // buffer index of the first real byte

  for (int w = threadIdx.x; w < kValues / 4; w += kThreads) {
    const uint32_t v = __ldg(src + w);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = 4 * w + j;
      const uint32_t gv = gear((v >> (8 * j)) & 0xFFu);
      g[slot(i)] = tile0 + i < first_real ? 0u : gv;
    }
  }
  __syncthreads();

  const int p0 = threadIdx.x * kRun;  // the run's first position in the tile
  uint32_t h = 0;
#pragma unroll
  for (int j = kWindow - 1; j > 0; --j) h = (h << 1) + g[slot(kLead + p0 - j)];
  uint32_t m[kRun / 4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < kRun; ++i) {
    h = (h << 1) + g[slot(kLead + p0 + i)];
    const uint32_t hit = (uint32_t)((h & mask_s) == 0u) |
                         ((uint32_t)((h & mask_l) == 0u) << 1);
    m[i / 4] |= hit << (8 * (i % 4));
  }
  if (tile0 + p0 < n) {
    *reinterpret_cast<uint4*>(out + tile0 + p0) = make_uint4(m[0], m[1], m[2], m[3]);
  }
}

}  // namespace

extern "C" {

// Launches the kernel on ``stream`` for a window of n positions (layout
// above). Returns cudaGetLastError(): 0 when the launch was accepted.
int gear_mask_launch(const void* buf, int64_t n, int hist, uint32_t mask_s,
                     uint32_t mask_l, void* out, void* stream) {
  if (n > 0) {
    const int64_t blocks = (n + kTile - 1) / kTile;
    gear_mask_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)buf, n, hist, mask_s, mask_l, (uint8_t*)out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
