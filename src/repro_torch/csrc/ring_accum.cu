// The ring reduction's dequantize-and-accumulate (Algorithm 2, ring
// collective) for Hopper:
//
//     acc[r, j] = acc[r, j] + coef[r] * float(q[r, j])
//
// for the rows r of one received chunk, in place on the f32 accumulator.
// Rows are wire blocks of 2048 elements; q is the ENCODED uplink payload
// (int16 at <= 16 bits, int32 at 17..31, f32 unquantized) and coef[r]
// folds the source worker's normalized weight and the block's
// quantization scale into one multiplier, so the payload is decoded
// during the accumulate and no f32 copy of it is ever written.
//
// Replaces repro/kernels/ring_wavg/kernel.py::ring_accum_pallas, the
// Pallas TPU kernel that streams one (1, 2048) block per grid step
// through VMEM with the accumulator aliased onto its output.
//
// Bound: HBM bytes. Per element it reads acc (4 B) and q (2 B at int16)
// and writes acc (4 B) for one multiply-add, far below the card's compute
// ridge. The design only has to keep HBM busy, and stays simple:
//   * one block of 2048 / VEC threads owns a row, where VEC = 16 B /
//     sizeof(wire type): each thread reads its VEC wire elements as ONE
//     16-byte load (8 int16, or 4 int32 or f32) and its accumulator
//     elements as float4s, so a warp touches contiguous 512-byte spans;
//   * coef is read once per row and thread (a broadcast load);
//   * a grid-stride loop over rows covers any row count;
//   * every element has exactly one writer: no atomics, deterministic.
// The caller passes base pointers of the chunk's rows (a contiguous slice
// of the (n_blocks, 2048) accumulator and the received chunk), which the
// wrapper checks are 16-byte aligned, and the SM count it read once: a
// launch queries nothing, so the ring's per-chunk launch costs the launch
// alone on the host. Making it faster (TMA, fusing the host-to-device
// copy of the chunk) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockN = 2048;  // wire block: kernels/ring_wavg/ops.py::BLOCK_N

template <typename T>
__global__ void __launch_bounds__(kBlockN * sizeof(T) / 16)
ring_accum_kernel(float* __restrict__ acc, const T* __restrict__ q,
                  const float* __restrict__ coef, long long rows) {
  constexpr int kVec = 16 / sizeof(T);  // wire elements per 16-byte load
  union Wire {
    uint4 raw;
    T v[kVec];
  };
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const float c = __ldg(coef + row);
    const long long base = row * kBlockN + (long long)threadIdx.x * kVec;
    Wire w;
    w.raw = __ldg(reinterpret_cast<const uint4*>(q + base));
    float4* a = reinterpret_cast<float4*>(acc + base);
#pragma unroll
    for (int i = 0; i < kVec / 4; ++i) {
      float4 x = a[i];
      x.x = fmaf(c, static_cast<float>(w.v[4 * i + 0]), x.x);
      x.y = fmaf(c, static_cast<float>(w.v[4 * i + 1]), x.y);
      x.z = fmaf(c, static_cast<float>(w.v[4 * i + 2]), x.z);
      x.w = fmaf(c, static_cast<float>(w.v[4 * i + 3]), x.w);
      a[i] = x;
    }
  }
}

template <typename T>
int launch(void* acc, const void* q, const void* coef, long long rows,
           int sms, void* stream) {
  constexpr int kThreads = kBlockN * sizeof(T) / 16;  // 256 or 512
  if (rows < 1 || sms < 1) return (int)cudaErrorInvalidValue;
  // 2048 resident threads an SM, four waves of them, then grid-stride
  const long long max_blocks = (long long)sms * (2048 / kThreads) * 4;
  const long long blocks = rows < max_blocks ? rows : max_blocks;
  ring_accum_kernel<T><<<(unsigned)blocks, kThreads, 0,
                         (cudaStream_t)stream>>>(
      static_cast<float*>(acc), static_cast<const T*>(q),
      static_cast<const float*>(coef), rows);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points, one per wire type, called through ctypes. `sms` is the
// card's SM count, which the caller reads once (it sizes the grid). Each
// launches on `stream` and returns cudaGetLastError() (0 on success);
// none synchronises, allocates or queries the device.
extern "C" int ring_accum_i16(void* acc, const void* q, const void* coef,
                              long long rows, int sms, void* stream) {
  return launch<int16_t>(acc, q, coef, rows, sms, stream);
}

extern "C" int ring_accum_i32(void* acc, const void* q, const void* coef,
                              long long rows, int sms, void* stream) {
  return launch<int32_t>(acc, q, coef, rows, sms, stream);
}

extern "C" int ring_accum_f32(void* acc, const void* q, const void* coef,
                              long long rows, int sms, void* stream) {
  return launch<float>(acc, q, coef, rows, sms, stream);
}
