// Algorithm 2 (the server's discriminator average) for Hopper:
//
//     out[n] = sum_k w[k] * x[k, n]      x (K, N) f32, w (K,) f32 normalized
//
// Replaces repro/kernels/wavg/kernel.py::wavg_pallas, the Pallas TPU
// kernel that streams (K, 2048) tiles through VMEM and reduces each with a
// (1, K) x (K, 2048) product on the MXU.
//
// Bound: HBM bytes. The kernel reads K*N*4 bytes and writes N*4 for 2*K*N
// flops, about half a flop per byte, far below the card's compute ridge;
// at the DCGAN discriminator's shape (K = 10, N = 2,765,568) the payload is
// 110.6 MB, past the 50 MB L2, so it really streams from HBM. The design
// therefore only has to keep HBM busy:
//   * each thread owns 4 consecutive columns and reads them as one 16-byte
//     float4 per row, so a warp reads 512 contiguous bytes of a row;
//   * the K loads of a column group are independent (the k loop is
//     unrolled), so many are in flight per thread;
//   * w sits in shared memory, read by every thread as a broadcast;
//   * x is loaded with the streaming (evict-first) hint and never reused;
//   * each column is accumulated in f32 in a fixed k order: no atomics,
//     so results are deterministic;
//   * a grid-stride loop covers any N; the kernel masks its own edge, so
//     no padding to the TPU kernel's 2048-column blocks is needed.
// Rows are 16-byte aligned only when N % 4 == 0 (and the buffers are), so
// otherwise every column takes the scalar path. Making it faster (TMA,
// deeper pipelining) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxK = 12288;  // w in at most 48 KiB of shared memory

__global__ void __launch_bounds__(kThreads)
wavg_kernel(const float* __restrict__ x, const float* __restrict__ w,
            float* __restrict__ out, long long K, long long N,
            long long n_vec) {
  extern __shared__ float w_s[];
  for (long long k = threadIdx.x; k < K; k += blockDim.x) w_s[k] = w[k];
  __syncthreads();

  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;

  // Vector part: float4 column groups [0, n_vec); n_vec is N / 4 when the
  // rows are 16-byte aligned, else 0.
  const float4* __restrict__ x4 = reinterpret_cast<const float4*>(x);
  float4* __restrict__ out4 = reinterpret_cast<float4*>(out);
  for (long long i = tid; i < n_vec; i += stride) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (long long k = 0; k < K; ++k) {
      const float4 v = __ldcs(x4 + k * n_vec + i);
      const float wk = w_s[k];
      acc.x = fmaf(wk, v.x, acc.x);
      acc.y = fmaf(wk, v.y, acc.y);
      acc.z = fmaf(wk, v.z, acc.z);
      acc.w = fmaf(wk, v.w, acc.w);
    }
    out4[i] = acc;
  }

  // Scalar part: the columns the vector part did not cover.
  for (long long n = 4 * n_vec + tid; n < N; n += stride) {
    float acc = 0.f;
#pragma unroll 8
    for (long long k = 0; k < K; ++k) acc = fmaf(w_s[k], __ldcs(x + k * N + n), acc);
    out[n] = acc;
  }
}

}  // namespace

// C entry point, called through ctypes. Launches on `stream` and returns
// cudaGetLastError() (0 on success); it neither synchronises nor allocates.
extern "C" int wavg_f32(const void* x, const void* w, void* out, long long K,
                        long long N, void* stream) {
  if (K < 1 || K > kMaxK || N < 1) return (int)cudaErrorInvalidValue;
  const bool aligned = N % 4 == 0 && (uintptr_t)x % 16 == 0 &&
                       (uintptr_t)out % 16 == 0;
  const long long n_vec = aligned ? N / 4 : 0;
  const long long work = aligned ? n_vec : N;

  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;

  long long blocks = (work + kThreads - 1) / kThreads;
  const long long max_blocks = (long long)sms * 32;
  if (blocks > max_blocks) blocks = max_blocks;

  wavg_kernel<<<(unsigned)blocks, kThreads, K * sizeof(float),
                (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(out), K, N, n_vec);
  return (int)cudaGetLastError();
}
