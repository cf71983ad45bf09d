// Causal grouped-query flash attention forward, hand-written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `flash_attention_pallas` (src/repro/kernels/
// flash_attn/kernel.py, body `_flash_kernel`). Per (batch, head) and
// query row i, over the keys j it may see (j <= i when causal, j > i -
// window when windowed, j < s):
//
//   out_i = sum_j exp(s_ij - m_i) v_j / l_i,   s_ij = (scale q_i) . k_j
//   lse_i = m_i + log(max(l_i, 1e-30))
//
// with the running maximum m_i and sum l_i of an online softmax over
// tiles of keys, accumulated in float32, and 1 / max(l, 1e-30) as the
// reference takes it. lse is written for the backward (the port's
// FlashAttention-2 backward runs in PyTorch on the saved residuals).
//
// What bounds it on the card: arithmetic. At the main shape (b 4, s
// 1024, H 32, KV 8, D 64, causal) the least work is 4 b H D s(s+1)/2 =
// 17.2 GFLOP on ~84 MB of inputs and outputs, so the float32 units are
// the limit (no TF32 and no tensor cores: the parity tolerance is
// float32's, 2e-5, and TF32 keeps about three digits). The design, a
// first simple one:
//   - one block of 256 threads per (batch, head, 64 query rows), the
//     blocks with the most key tiles (the last rows) scheduled first;
//   - the scaled Q tile and one 64-row tile of K and of V in shared
//     memory, read from the caller's (b, s, heads, D) layout through its
//     strides: no fold copy, no pad, and kv head h / (H / KV) indexed
//     directly, never repeated; rows past s are zero and masked;
//   - key tiles run from the window's first reachable tile to the causal
//     frontier; tiles no query of the block can see are never loaded,
//     as the Pallas kernel's `reachable` test skips them;
//   - each thread holds a 4 x 4 block of the score tile, the running
//     (m, l) of its 4 rows and a 4 x D/16 block of the accumulator in
//     registers; products are register-blocked float32 FMAs over 16-byte
//     shared-memory loads, rows padded by 4 floats so a warp's loads fall
//     in distinct banks; row maxima and sums are reduced over the 16
//     threads of a row with warp shuffles;
//   - the probabilities go through shared memory (one 64 x 64 tile) to
//     the P V product.
// Tensor cores (wgmma in bf16 with float32 accumulation), TMA and a
// double-buffered K/V ring are later work.
//
// Layouts: q (b, s, H, D); k, v (b, s, KV, D); float32 or bfloat16, unit
// stride in D. out (b, s, H, D) float32, contiguous; lse (b, H, s)
// float32, contiguous. D is 32, 64 or 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;         // query rows per block
constexpr int BK = 64;         // key rows per tile
constexpr int THREADS = 256;   // 16 x 16: ty owns 4 rows, tx 4 keys
constexpr int PS = BK + 4;     // padded row of the probability tile

struct Args {
  const void* q;
  const void* k;
  const void* v;
  float* out;
  float* lse;
  int b, s, h, kv, causal, window;
  float scale;
  long long sqb, sqs, sqh, skb, sks, skh, svb, svs, svh;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <int W>
struct Vec;
template <>
struct Vec<4> {
  __device__ static void load(const float* p, float* r) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    r[0] = t.x; r[1] = t.y; r[2] = t.z; r[3] = t.w;
  }
  __device__ static void store(float* p, const float* r) {
    *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
  }
};
template <>
struct Vec<2> {
  __device__ static void load(const float* p, float* r) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    r[0] = t.x; r[1] = t.y;
  }
  __device__ static void store(float* p, const float* r) {
    *reinterpret_cast<float2*>(p) = make_float2(r[0], r[1]);
  }
};

// T: the type of q, k and v. D: head_dim.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_attn_kernel(Args a) {
  constexpr int QS = D + 4;            // padded row of the Q and K tiles
  constexpr int CPT = D / 16;          // accumulator columns per thread
  constexpr int VW = CPT >= 4 ? 4 : CPT;   // their vector width
  constexpr int NCH = CPT / VW;        // vectors per row; vector c of
                                       // thread tx: columns c*16*VW + tx*VW

  extern __shared__ float4 smem_f4[];
  float* Qs = reinterpret_cast<float*>(smem_f4);   // (BQ, QS) scale * q
  float* Ks = Qs + BQ * QS;                        // (BK, QS)
  float* Vs = Ks + BK * QS;                        // (BK, D)
  float* Ps = Vs + BK * D;                         // (BQ, PS)

  const int n_qt = (a.s + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * BQ;   // last rows first
  const int hh = blockIdx.y, bb = blockIdx.z;
  const int kvh = hh / (a.h / a.kv);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  const T* qb = static_cast<const T*>(a.q) + bb * a.sqb + hh * a.sqh;
  const T* kb = static_cast<const T*>(a.k) + bb * a.skb + kvh * a.skh;
  const T* vb = static_cast<const T*>(a.v) + bb * a.svb + kvh * a.svh;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, c = e % D, t = q0 + r;
    Qs[r * QS + c] = t < a.s ? to_f32(qb[t * a.sqs + c]) * a.scale : 0.f;
  }

  // the key tiles some query of the block can see
  const int q_last = min(q0 + BQ - 1, a.s - 1);
  const int kt_end = (a.causal ? q_last : a.s - 1) / BK;
  int kt_begin = 0;
  if (a.window > 0 && q0 - a.window + 1 > 0) kt_begin = (q0 - a.window + 1) / BK;

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  for (int kt = kt_begin; kt <= kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // the last tile's K, V and P are read; Q is written
    for (int e = tid; e < BK * D; e += THREADS) {
      const int r = e / D, c = e % D, t = k0 + r;
      const bool in = t < a.s;
      Ks[r * QS + c] = in ? to_f32(kb[t * a.sks + c]) : 0.f;
      Vs[r * D + c] = in ? to_f32(vb[t * a.svs + c]) : 0.f;
    }
    __syncthreads();

    // scores of rows 4 ty + i against keys tx + 16 j
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float qr[4][4], kr[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) Vec<4>::load(&Qs[(4 * ty + i) * QS + d], qr[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) Vec<4>::load(&Ks[(tx + 16 * j) * QS + d], kr[j]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[i][j] = fmaf(qr[i][e], kr[j][e], sc[i][j]);
    }

    // online softmax of the tile, row by row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + 4 * ty + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        bool ok = kj < a.s;
        if (a.causal) ok = ok && kj <= qi;
        if (a.window > 0) ok = ok && kj > qi - a.window;
        sc[i][j] = ok ? sc[i][j] : -INFINITY;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      // a row that has seen no key yet keeps p = 0 and its zero sums
      const float base = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m[i] - base);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - base);
        sum += p;
        Ps[(4 * ty + i) * PS + tx + 16 * j] = p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // acc += P V
#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float pr[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) Vec<4>::load(&Ps[(4 * ty + i) * PS + j], pr[i]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float vr[CPT];
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch)
          Vec<VW>::load(&Vs[(j + e) * D + ch * 16 * VW + tx * VW], &vr[ch * VW]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(pr[i][e], vr[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * ty + i;
    if (r >= a.s) continue;
    const float ls = fmaxf(l[i], 1e-30f);
    float* o = a.out + (((long long)bb * a.s + r) * a.h + hh) * D;
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) {
      float w[VW];
#pragma unroll
      for (int e = 0; e < VW; ++e) w[e] = acc[i][ch * VW + e] / ls;
      Vec<VW>::store(&o[ch * 16 * VW + tx * VW], w);
    }
    if (tx == 0) a.lse[((long long)bb * a.h + hh) * a.s + r] = m[i] + logf(ls);
  }
}

template <typename T, int D>
int launch(const Args& a, cudaStream_t stream) {
  auto kernel = flash_attn_kernel<T, D>;
  constexpr size_t smem = sizeof(float) * (2 * BQ * (D + 4) + BK * D + BQ * PS);
  // set once per template instance: the attribute outlives the launch
  static bool allowed = false;
  if (!allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    allowed = true;
  }
  dim3 grid((a.s + BQ - 1) / BQ, a.h, a.b);
  kernel<<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point, called through ctypes. Launches on `stream` and returns
// cudaGetLastError() (0 on success); it neither synchronises nor allocates.
extern "C" int flash_attn(const void* q, const void* k, const void* v,
                          float* out, float* lse, void* stream, int b, int s,
                          int h, int kv, int d, int causal, int window,
                          int bf16, long long sqb, long long sqs,
                          long long sqh, long long skb, long long sks,
                          long long skh, long long svb, long long svs,
                          long long svh) {
  if (b < 1 || b > 65535 || s < 1 || h < 1 || h > 65535 || kv < 1 ||
      h % kv != 0 || window < 0)
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, out, lse, b, s, h, kv, causal, window,
         (float)(1.0 / sqrt((double)d)), sqb, sqs, sqh, skb, sks, skh, svb,
         svs, svh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      return bf16 ? launch<__nv_bfloat16, 32>(a, st) : launch<float, 32>(a, st);
    case 64:
      return bf16 ? launch<__nv_bfloat16, 64>(a, st) : launch<float, 64>(a, st);
    case 128:
      return bf16 ? launch<__nv_bfloat16, 128>(a, st) : launch<float, 128>(a, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
