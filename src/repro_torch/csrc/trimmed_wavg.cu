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
// flops, a few operations per byte, below the card's compute ridge but
// close enough to it that the instructions a column count as much as the
// bytes. At the DCGAN shapes (K = 10, N = 2,765,568 or 6,342,272) the
// payload is past the 50 MB L2, so it streams from HBM. The design is
// wavg.cu's stream with the selection in registers:
//   * a thread owns 4 consecutive columns and reads each row's as one
//     16-byte float4 with the streaming (evict-first) hint, all K loads in
//     flight at once, when N % 4 == 0 and x and out are 16-byte aligned;
//     otherwise every column takes the scalar path, one column a thread;
//   * the columns' values live in registers, every loop over k unrolled:
//     one instance for each K up to 16 (the paper's K is 10), so no
//     iteration is dead, and for larger K the smallest of KMAX = 32, 64
//     that holds it (rows k >= K are never included; one column a
//     thread);
//   * the inclusion set is a 32-bit mask for K <= 32 (64-bit past it); a
//     pass keeps the chosen row as a one-hot mask, so removing it is one
//     and-not;
//   * w sits in shared memory and in registers; the participant mask and
//     count are computed from it on the device by every thread: no host
//     sync;
//   * each pass scans k DOWNWARD with a non-strict compare (>= for the
//     max from -inf, <= for the min from +inf), so the last row it takes
//     is the lowest index among ties, the reference's first occurrence,
//     with no test of whether a row was taken yet; the sum runs in f32 in
//     a fixed k order (upward), with no atomics, so results are
//     deterministic;
//   * a grid-stride loop covers any N; the kernel masks its own edge, so
//     no padding to the TPU kernel's 2048-column blocks is needed.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>
#include <utility>

namespace {

constexpr int kThreads = 128;
constexpr long long kMaxK = 64;  // the widest inclusion set is one uint64_t

// KMAX rows (K <= KMAX; K == KMAX when EXACT), V columns a thread: 4
// (float4 loads) or 1.
template <int KMAX, int V, bool EXACT>
__global__ void __launch_bounds__(kThreads)
trimmed_wavg_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    float* __restrict__ out, int K, long long N, int trim) {
  using Mask = std::conditional_t<(KMAX <= 32), uint32_t, uint64_t>;
  __shared__ float w_s[KMAX];
  for (int k = threadIdx.x; k < KMAX; k += blockDim.x)
    w_s[k] = k < K ? w[k] : 0.f;
  __syncthreads();

  float wk[KMAX];
  Mask part = 0;
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    wk[k] = w_s[k];
    if (wk[k] > 0.f) part |= Mask(1) << k;
  }
  int n_part;
  if constexpr (KMAX <= 32) n_part = __popc(part);
  else n_part = __popcll(part);
  // Pair i is removed only while n_part >= 2 i + 3: a round-wide count.
  int pairs = n_part >= 3 ? (n_part - 1) / 2 : 0;
  if (pairs > trim) pairs = trim;

  const long long groups = N / V;   // V divides N (the launcher's rule)
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < groups; i += stride) {
    float v[KMAX][V];
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (EXACT || k < K) {
        if constexpr (V == 4) {
          const float4 r =
              __ldcs(reinterpret_cast<const float4*>(x + k * N) + i);
          v[k][0] = r.x; v[k][1] = r.y; v[k][2] = r.z; v[k][3] = r.w;
        } else {
          v[k][0] = __ldcs(x + k * N + i);
        }
      } else {
#pragma unroll
        for (int c = 0; c < V; ++c) v[k][c] = 0.f;
      }
    }

    Mask inc[V];
#pragma unroll
    for (int c = 0; c < V; ++c) inc[c] = part;
    for (int p = 0; p < pairs; ++p) {
      // n_part - 2 p >= 3 rows are still included, so both passes find one.
#pragma unroll
      for (int c = 0; c < V; ++c) {
        float best = -INFINITY;
        Mask pick = 0;
#pragma unroll
        for (int k = KMAX - 1; k >= 0; --k) {
          const bool take = (inc[c] & (Mask(1) << k)) && v[k][c] >= best;
          best = take ? v[k][c] : best;
          pick = take ? Mask(1) << k : pick;
        }
        inc[c] &= ~pick;
        best = INFINITY;
        pick = 0;
#pragma unroll
        for (int k = KMAX - 1; k >= 0; --k) {
          const bool take = (inc[c] & (Mask(1) << k)) && v[k][c] <= best;
          best = take ? v[k][c] : best;
          pick = take ? Mask(1) << k : pick;
        }
        inc[c] &= ~pick;
      }
    }

    float res[V];
#pragma unroll
    for (int c = 0; c < V; ++c) {
      float num = 0.f, den = 0.f;
#pragma unroll
      for (int k = 0; k < KMAX; ++k) {
        const float wi = (inc[c] & (Mask(1) << k)) ? wk[k] : 0.f;
        num = fmaf(wi, v[k][c], num);
        den += wi;
      }
      res[c] = num / fmaxf(den, 1e-12f);
    }
    if constexpr (V == 4)
      reinterpret_cast<float4*>(out)[i] =
          make_float4(res[0], res[1], res[2], res[3]);
    else
      out[i] = res[0];
  }
}

template <int KMAX, int V, bool EXACT = false>
void launch(const float* x, const float* w, float* out, int K, long long N,
            int trim, cudaStream_t stream) {
  // One column group per thread; the grid-stride loop only matters past
  // the grid's x limit.
  long long blocks = (N / V + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) blocks = 0x7fffffffLL;
  trimmed_wavg_kernel<KMAX, V, EXACT>
      <<<(unsigned)blocks, kThreads, 0, stream>>>(x, w, out, K, N, trim);
}

// Exact-K instances for K <= 16: four columns a thread where aligned.
template <int K>
void launch_exact(const float* x, const float* w, float* out, long long N,
                  int trim, bool vec, cudaStream_t stream) {
  if (vec) launch<K, 4, true>(x, w, out, K, N, trim, stream);
  else launch<K, 1, true>(x, w, out, K, N, trim, stream);
}

template <int... Ks>
void dispatch_exact(std::integer_sequence<int, Ks...>, int K, const float* x,
                    const float* w, float* out, long long N, int trim,
                    bool vec, cudaStream_t stream) {
  ((K == Ks + 1 ? launch_exact<Ks + 1>(x, w, out, N, trim, vec, stream)
                : void()),
   ...);
}

}  // namespace

// C entry point, called through ctypes. Launches on `stream` and returns
// cudaGetLastError() (0 on success); it neither synchronises nor allocates.
extern "C" int trimmed_wavg_f32(const void* x, const void* w, void* out,
                                long long K, long long N, int trim,
                                void* stream) {
  if (K < 1 || K > kMaxK || N < 1 || trim < 0)
    return (int)cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // Rows are 16-byte aligned only when N % 4 == 0 (and the buffers are).
  const bool vec = N % 4 == 0 && (uintptr_t)x % 16 == 0 &&
                   (uintptr_t)out % 16 == 0;
  const int k = (int)K;
  if (K <= 16)
    dispatch_exact(std::make_integer_sequence<int, 16>(), k, xf, wf, of, N,
                   trim, vec, s);
  else if (K <= 32) launch<32, 1>(xf, wf, of, k, N, trim, s);
  else launch<64, 1>(xf, wf, of, k, N, trim, s);
  return (int)cudaGetLastError();
}
