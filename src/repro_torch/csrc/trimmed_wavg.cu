// Robust Algorithm 2 (the weighted coordinate trimmed mean) for Hopper:
//
//     out[n] = sum_{k in S_n} w[k] x[k, n] / max(sum_{k in S_n} w[k], 1e-12)
//
// x (K, N) f32, w (K,) f32 RAW weights (0 = not participating). S_n starts
// as the participants (w > 0); `trim` times, the column's max and then the
// min of the rows still included are removed, each time the FIRST (lowest
// index) occurrence, and pair i only while the round has
// n_part >= 2 i + 3 participants.
//
// Replaces repro/kernels/robust_avg/kernel.py::trimmed_wavg_pallas, the
// Pallas TPU kernel that streams (K, 2048) tiles through VMEM and runs
// `trim` unrolled masked max/min passes over each tile on the VPU.
//
// Bound: HBM bytes. The kernel reads K*N*4 bytes of x once and writes N*4;
// the selection costs about 2*trim*K compares per column and the sum 2*K
// flops, a few operations per byte, far below the card's compute ridge. At
// the DCGAN shapes (K = 10, N = 2,765,568 or 6,342,272) the payload is past
// the 50 MB L2, so it streams from HBM. The design keeps HBM busy and
// every later pass on chip:
//   * one thread owns one column; for each row k a warp reads 128
//     contiguous bytes, with the streaming (evict-first) hint;
//   * the column's K values live in registers: the kernel is instantiated
//     for KMAX in {8, 12, 16, 32, 64} (the smallest that holds K) and every
//     loop over k is unrolled to KMAX, so the values are addressed
//     statically; rows k >= K are never included. Registers, not a
//     shared-memory tile: with the tile, the passes' shared-memory loads
//     and branches bound the kernel by instruction issue, at about half
//     this speed on an H100. The inclusion set is a 64-bit mask in a
//     register;
//   * w sits in shared memory and the participant mask and count are
//     computed from it on the device by every thread: no host sync;
//   * the max/min passes scan k upward with strict compares, which keeps
//     the lowest index among ties, as selects without branches; the sum
//     runs in f32 in a fixed k order, with no atomics, so results are
//     deterministic;
//   * a grid-stride loop covers any N; the kernel masks its own edge, so
//     no padding to the TPU kernel's 2048-column blocks is needed.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr long long kMaxK = 64;  // the inclusion set is one uint64_t

template <int KMAX>
__global__ void __launch_bounds__(kThreads)
trimmed_wavg_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    float* __restrict__ out, int K, long long N, int trim) {
  __shared__ float w_s[KMAX];
  for (int k = threadIdx.x; k < KMAX; k += blockDim.x)
    w_s[k] = k < K ? w[k] : 0.f;
  __syncthreads();

  uint64_t part = 0;
#pragma unroll
  for (int k = 0; k < KMAX; ++k)
    if (w_s[k] > 0.f) part |= 1ull << k;
  const int n_part = __popcll(part);
  // Pair i is removed only while n_part >= 2 i + 3: a round-wide count.
  int pairs = n_part >= 3 ? (n_part - 1) / 2 : 0;
  if (pairs > trim) pairs = trim;

  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x; n < N;
       n += stride) {
    float v[KMAX];
#pragma unroll
    for (int k = 0; k < KMAX; ++k)
      v[k] = k < K ? __ldcs(x + k * N + n) : 0.f;

    uint64_t inc = part;
    for (int i = 0; i < pairs; ++i) {
      // n_part - 2 i >= 3 rows are still included, so both passes find one.
      int arg = -1;
      float best = -INFINITY;
#pragma unroll
      for (int k = 0; k < KMAX; ++k) {
        const bool take = ((inc >> k) & 1ull) && (arg < 0 || v[k] > best);
        best = take ? v[k] : best;
        arg = take ? k : arg;
      }
      inc &= ~(1ull << arg);
      arg = -1;
      best = INFINITY;
#pragma unroll
      for (int k = 0; k < KMAX; ++k) {
        const bool take = ((inc >> k) & 1ull) && (arg < 0 || v[k] < best);
        best = take ? v[k] : best;
        arg = take ? k : arg;
      }
      inc &= ~(1ull << arg);
    }

    float num = 0.f, den = 0.f;
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      const float wk = ((inc >> k) & 1ull) ? w_s[k] : 0.f;
      num = fmaf(wk, v[k], num);
      den += wk;
    }
    out[n] = num / fmaxf(den, 1e-12f);
  }
}

template <int KMAX>
void launch(const float* x, const float* w, float* out, int K, long long N,
            int trim, unsigned blocks, cudaStream_t stream) {
  trimmed_wavg_kernel<KMAX><<<blocks, kThreads, 0, stream>>>(x, w, out, K,
                                                             N, trim);
}

}  // namespace

// C entry point, called through ctypes. Launches on `stream` and returns
// cudaGetLastError() (0 on success); it neither synchronises nor allocates.
extern "C" int trimmed_wavg_f32(const void* x, const void* w, void* out,
                                long long K, long long N, int trim,
                                void* stream) {
  if (K < 1 || K > kMaxK || N < 1 || trim < 0)
    return (int)cudaErrorInvalidValue;
  // One column per thread; the grid-stride loop only matters past the
  // grid's x limit.
  long long blocks = (N + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) blocks = 0x7fffffffLL;
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned b = (unsigned)blocks;
  const int k = (int)K;
  if (K <= 8) launch<8>(xf, wf, of, k, N, trim, b, s);
  else if (K <= 12) launch<12>(xf, wf, of, k, N, trim, b, s);
  else if (K <= 16) launch<16>(xf, wf, of, k, N, trim, b, s);
  else if (K <= 32) launch<32>(xf, wf, of, k, N, trim, b, s);
  else launch<64>(xf, wf, of, k, N, trim, b, s);
  return (int)cudaGetLastError();
}
