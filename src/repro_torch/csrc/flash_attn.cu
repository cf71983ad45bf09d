// Grouped-query flash attention forward (causal, sliding-window or
// bidirectional), hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel `flash_attention_pallas` (src/repro/kernels/
// flash_attn/kernel.py, body `_flash_kernel`), which takes s queries
// against t keys of their own length. Per (batch, head) and query row i
// (i < s), over the keys j it may see (j < t; j <= i when causal, j > i -
// window when windowed: query i and key j sit at positions i and j, as
// in the Pallas kernel, so the masks keep their meaning when t != s):
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
// 17.2 GFLOP on ~84 MB of inputs and outputs. The parity tolerance is
// float32's (2e-5), so both products run on the tensor cores at float32
// accuracy: TF32 in three passes of the big/small split (tf32x3.cuh);
// one pass keeps about three digits. They run as Hopper's warpgroup
// products (wgmma m64nNk8 .tf32), which read their B operand (and Q) from
// shared memory themselves; the same design on `mma.sync` m16n8k8, where
// every warp loads every K and V fragment through its registers, took
// 0.53-0.55 ms at the main shape on an H100 against 0.39 ms, bound by
// those loads and their issue. The design is FlashAttention-2's, one warpgroup
// (4 warps) on 64 query rows:
//   - grid (H, b, query tiles), the last rows (the most key tiles) in
//     the first wave of every head; a block of WG warpgroups shares one
//     K/V pipeline;
//   - S = Q K^T (A = Q from shared memory) lands in registers, a thread
//     holding keys (2t, 2t+1) of each 8-key step for its two rows; the
//     online softmax runs there (row max over the 4 lanes of a row by
//     shuffles, the row sum once at the end, a row that has seen no key
//     yet keeps p = 0, exponentials in base 2 with log2 e folded into
//     Q's scale), and P stays there: it is P V's A operand once A's
//     column t is read as key 2t and column t+4 as key 2t+1, the order
//     in which V^T holds the keys of each 8-step (the sum over keys does
//     not care about their order);
//   - every operand is split once: Q as the block starts, each K and V
//     tile as it lands in shared memory (big and small arrays, in the
//     K-major layout wgmma reads), P by the thread that holds it;
//   - K and V are read through the caller's strides by 16-byte cp.async
//     (zero-filled past t) into a double-buffered stage: K lands where
//     its big values go and is split in place, V lands in a raw tile
//     and is split into V^T, each chunk by the thread that copied it
//     once its own copy is complete, so the only barrier of a key tile
//     is the one that hands the stage over. Tile kt + 1 loads while
//     tile kt is multiplied, and is split while tile kt's P V runs;
//   - key tiles run from the window's first reachable tile to the causal
//     frontier (the Pallas kernel's `reachable` test); a warpgroup skips
//     the products of a tile none of its rows can see, and the masks of
//     a tile all of its rows see whole.
// Instances (shared memory: Cfg<D>::SMEM below; registers a thread, f32 /
// bf16 inputs: `nvcc -Xptxas -v` with CUDA 12.8, no spills; 8 resident
// warps an SM at D 64 and 128):
//   D  32: 1 warpgroup,  64-key tiles,  90,368 B, 192 / 191: 2 blocks an SM
//   D  64: 2 warpgroups, 64-key tiles, 213,504 B, 213 / 214: 1 block an SM
//   D  80: 2 warpgroups, 32-key tiles, 174,720 B:              1 block an SM
//   D 128: 2 warpgroups, 16-key tiles, 205,824 B, 201 / 211: 1 block an SM
//   D 256: 1 warpgroup,   8-key tiles, 206,848 B, 208 / 208: 1 block an SM
//
// Every query sees at least one key: the wrapper (`_check` in
// kernels/flash_attn/ops.py) refuses a window with t + window <= s, the
// only calls that would leave a query none (self-attention sees its own
// key, cross-attention every key).
//
// Layouts: q (b, s, H, D); k, v (b, t, KV, D); float32 or bfloat16, unit
// stride in D, 16-byte aligned with strides of whole 16 bytes (the
// wrapper copies what is not). out (b, s, H, D) float32, contiguous; lse
// (b, H, s) float32, contiguous. D is 32, 64, 80, 128 or 256.
//
// Every loop over D steps by 8 (a k-step of Q K^T, a column block of the
// accumulator) or by a 16-byte chunk (4 floats, 8 bfloat16s), so any D
// that is a multiple of 8 tiles whole; D 80 (zamba2-2.7b: 2,560 / 32)
// runs P V as one m64n80k8 product a k-step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

using tf32x3::cp16;
using tf32x3::cp_commit;
using tf32x3::cp_wait;
using tf32x3::fence_async_shared;
using tf32x3::reg_fence;
using tf32x3::smem_desc;
using tf32x3::split;
using tf32x3::wgmma_commit;
using tf32x3::wgmma_fence;
using tf32x3::wgmma_rs;
using tf32x3::wgmma_ss;
using tf32x3::wgmma_wait;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  float* out;
  float* lse;
  int b, s, t, h, kv, causal, window;   // s queries, t keys
  float scale;   // log2(e) / sqrt(D): scores in base 2
  long long sqb, sqs, sqh, skb, sks, skh, svb, svs, svh;
};

// Per head_dim: warpgroups a block (64 query rows each), keys a tile,
// blocks an SM (launch bounds). Shared memory holds K-major operands
// without swizzle (core matrices of 8 rows x 16 bytes, LBO = 128 bytes
// along K): Q (BQ x D) and each stage's K (BK x D) with SBO = 32 D bytes,
// V^T (D x BK) with SBO = 32 BK + 16 bytes (the 16 spread the transposing
// writes over the banks); big and small arrays of each; one raw V tile.
template <int D, int WG_, int BK_, int BLOCKS_>
struct Tiles {
  static constexpr int WG = WG_, THREADS = 128 * WG_, BK = BK_;
  static constexpr int BLOCKS = BLOCKS_, BQ = 64 * WG_;
  static constexpr int QK_SBO = 32 * D, V_SBO = 32 * BK + 16;
  static constexpr int Q_BYTES = BQ * D * 4, K_BYTES = BK * D * 4;
  static constexpr int V_BYTES = D / 8 * V_SBO;
  static constexpr int STAGE = 2 * K_BYTES + 2 * V_BYTES;
  static constexpr int SMEM = 2 * Q_BYTES + 2 * STAGE + BK * D * 4;
};
template <int D>
struct Cfg;
template <>
struct Cfg<32> : Tiles<32, 1, 64, 2> {};
template <>
struct Cfg<64> : Tiles<64, 2, 64, 1> {};
template <>
struct Cfg<80> : Tiles<80, 2, 32, 1> {};
template <>
struct Cfg<128> : Tiles<128, 2, 16, 1> {};
template <>
struct Cfg<256> : Tiles<256, 1, 8, 1> {};
static_assert(Cfg<32>::SMEM == 90368 && Cfg<64>::SMEM == 213504 &&
                  Cfg<80>::SMEM == 174720 && Cfg<128>::SMEM == 205824 &&
                  Cfg<256>::SMEM == 206848,
              "the source note's shared memory");

// Byte offset of element (row, k) of a K-major operand with stride `sbo`.
__device__ __forceinline__ int kmajor(int row, int k, int sbo) {
  return (row >> 3) * sbo + (k >> 2) * 128 + (row & 7) * 16 + (k & 3) * 4;
}

// The 16 bytes at p as float32 values: 4 floats or 8 bfloat16s.
__device__ __forceinline__ void unpack(const void* p, float (&v)[4]) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
}
__device__ __forceinline__ void unpack(const void* p, float (&v)[8]) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Splits 4 consecutive values of a row (one core-matrix row) into the
// big and small arrays at byte offset `off`.
__device__ __forceinline__ void split4(unsigned char* big,
                                       unsigned char* small, int off,
                                       const float* v) {
  uint4 b, s;
  split(v[0], b.x, s.x);
  split(v[1], b.y, s.y);
  split(v[2], b.z, s.z);
  split(v[3], b.w, s.w);
  *reinterpret_cast<uint4*>(big + off) = b;
  *reinterpret_cast<uint4*>(small + off) = s;
}

// 2^x by the special function unit (relative error ~2^-22; 2^-inf = 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// T: the type of q, k and v. D: head_dim.
template <typename T, int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS, Cfg<D>::BLOCKS)
    flash_attn_kernel(Args a) {
  using C = Cfg<D>;
  constexpr int BK = C::BK, BQ = C::BQ, THREADS = C::THREADS;
  constexpr int E = 16 / sizeof(T);   // elements of a 16-byte chunk
  constexpr int CPR = D / E;          // chunks of a row

  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* const Qb = smem;                // Q big, then small
  unsigned char* const Qsm = smem + C::Q_BYTES;
  unsigned char* const raw = smem + 2 * C::Q_BYTES + 2 * C::STAGE;
  // stage `buf`: K big, K small, V^T big, V^T small
  auto Kb = [&](int buf) { return smem + 2 * C::Q_BYTES + buf * C::STAGE; };
  auto Ksm = [&](int buf) { return Kb(buf) + C::K_BYTES; };
  auto Vb = [&](int buf) { return Kb(buf) + 2 * C::K_BYTES; };
  auto Vsm = [&](int buf) { return Vb(buf) + C::V_BYTES; };

  const int n_qt = (a.s + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.z) * BQ;   // last rows first
  const int hh = blockIdx.x, bb = blockIdx.y;
  const int kvh = hh / (a.h / a.kv);
  const int tid = threadIdx.x, lane = tid & 31, wg = tid >> 7;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + 64 * wg;                      // the warpgroup's rows
  const int rw = r0 + 16 * ((tid >> 5) & 3) + g;    // this thread's rows:
                                                    // rw and rw + 8

  const T* qb = static_cast<const T*>(a.q) + bb * a.sqb + hh * a.sqh;
  const T* kb = static_cast<const T*>(a.k) + bb * a.skb + kvh * a.skh;
  const T* vb = static_cast<const T*>(a.v) + bb * a.svb + kvh * a.svh;

  // Tile k0, 16 bytes a copy: K chunks straight into the K big array at
  // their first core row (rows fastest across threads, so the split's
  // 16-byte stores fall in distinct banks), V chunks into the raw tile.
  auto load = [&](int buf, int k0) {
    for (int e = tid; e < BK * CPR; e += THREADS) {
      const int r = e % BK, c = e / BK, tk = k0 + r;
      const bool ok = tk < a.t;
      cp16(Kb(buf) + kmajor(r, c * E, C::QK_SBO),
           ok ? kb + (long long)tk * a.sks + c * E : kb, ok);
    }
    for (int e = tid; e < BK * CPR; e += THREADS) {
      const int r = e / CPR, c = e % CPR, tk = k0 + r;
      const bool ok = tk < a.t;
      cp16(raw + 16 * e, ok ? vb + (long long)tk * a.svs + c * E : vb, ok);
    }
    cp_commit();
  };
  // The same chunks, split by the thread that copied them: K in place,
  // V transposed into V^T with the keys of each 8-step paired as P's A
  // fragment reads them (key 2i + e at position i + 4e).
  auto split_tile = [&](int buf) {
    cp_wait<0>();
    for (int e = tid; e < BK * CPR; e += THREADS) {
      const int r = e % BK, c = e / BK;
      float v[E];
      unpack(Kb(buf) + kmajor(r, c * E, C::QK_SBO), v);
#pragma unroll
      for (int i = 0; i < E; i += 4)
        split4(Kb(buf), Ksm(buf), kmajor(r, c * E + i, C::QK_SBO), v + i);
    }
    for (int e = tid; e < BK * CPR; e += THREADS) {
      const int r = e / CPR, c = e % CPR;
      const int kp = (r & ~7) + ((r & 7) >> 1) + 4 * (r & 1);
      float v[E];
      unpack(raw + 16 * e, v);
#pragma unroll
      for (int i = 0; i < E; ++i) {
        const int off = kmajor(c * E + i, kp, C::V_SBO);
        uint32_t big, small;
        split(v[i], big, small);
        *reinterpret_cast<uint32_t*>(Vb(buf) + off) = big;
        *reinterpret_cast<uint32_t*>(Vsm(buf) + off) = small;
      }
    }
  };

  // the key tiles some query of the block can see
  const int q_last = min(q0 + BQ - 1, a.s - 1);
  const int kt_end = (a.causal ? min(q_last, a.t - 1) : a.t - 1) / BK;
  int kt_begin = 0;
  if (a.window > 0 && q0 - a.window + 1 > 0) kt_begin = (q0 - a.window + 1) / BK;

  load(0, kt_begin * BK);

  // Q, scaled and split once into the block's A operands
  for (int e = tid; e < BQ * CPR; e += THREADS) {
    const int r = e % BQ, c = e / BQ, tq = q0 + r;
    float v[E];
    if (tq < a.s) {
      const uint4 x = *reinterpret_cast<const uint4*>(
          qb + (long long)tq * a.sqs + c * E);
      unpack(&x, v);
    } else {
#pragma unroll
      for (int i = 0; i < E; ++i) v[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < E; ++i) v[i] *= a.scale;
#pragma unroll
    for (int i = 0; i < E; i += 4)
      split4(Qb, Qsm, kmajor(r, c * E + i, C::QK_SBO), v + i);
  }

  split_tile(0);
  fence_async_shared();

  float o[D / 2], m[2], l[2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    m[h] = -INFINITY;
    l[h] = 0.f;
  }
  const int q_off = 8 * wg * C::QK_SBO;   // the warpgroup's rows of Q

  for (int kt = kt_begin; kt <= kt_end; ++kt) {
    const int buf = (kt - kt_begin) & 1, k0 = kt * BK;
    // tile kt is split in `buf`; every product of tile kt - 1 is done
    __syncthreads();
    if (kt < kt_end) load(buf ^ 1, k0 + BK);

    // the warpgroup's rows see some key of the tile / every key of it
    const bool seen = r0 < a.s && (!a.causal || k0 <= r0 + 63) &&
                      (a.window == 0 || k0 + BK - 1 > r0 - a.window);
    const bool whole = k0 + BK <= a.t && (!a.causal || k0 + BK - 1 <= r0) &&
                       (a.window == 0 || k0 > r0 + 63 - a.window);
    if (seen) {
      // S = (scale Q) K^T in three TF32 passes; sc[4 j + 2 h + e]: row
      // rw + 8 h, key k0 + 8 j + 2 t + e
      float sc[BK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        const uint64_t qd_b = smem_desc(Qb + q_off + 256 * kk, 128, C::QK_SBO);
        const uint64_t qd_s = smem_desc(Qsm + q_off + 256 * kk, 128, C::QK_SBO);
        const uint64_t kd_b = smem_desc(Kb(buf) + 256 * kk, 128, C::QK_SBO);
        const uint64_t kd_s = smem_desc(Ksm(buf) + 256 * kk, 128, C::QK_SBO);
        wgmma_ss<BK>(sc, qd_s, kd_b, kk > 0);
        wgmma_ss<BK>(sc, qd_b, kd_s, 1);
        wgmma_ss<BK>(sc, qd_b, kd_b, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(sc);

      // online softmax of the tile
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int qi = rw + 8 * h;
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = sc[4 * j + 2 * h + e];
            if (!whole) {
              const int kj = k0 + 8 * j + 2 * t + e;
              bool ok = kj < a.t;
              if (a.causal) ok = ok && kj <= qi;
              if (a.window > 0) ok = ok && kj > qi - a.window;
              x = ok ? x : -INFINITY;
            }
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[h], mx);
        // a row that has seen no key yet keeps p = 0 and its zero sums
        const float base = m_new == -INFINITY ? 0.f : m_new;
        const float alpha = ex2(m[h] - base);
        m[h] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = sc[4 * j + 2 * h + e];
            x = ex2(x - base);
            sum += x;
          }
        l[h] = alpha * l[h] + sum;   // this thread's keys; lanes sum at the end
#pragma unroll
        for (int c = 0; c < D / 8; ++c) {
          o[4 * c + 2 * h] *= alpha;
          o[4 * c + 2 * h + 1] *= alpha;
        }
      }

      // O += P V in three TF32 passes: P's A fragment of 8-step j reads
      // column i as key 2i and column i + 4 as key 2i + 1, as V^T holds
      // them
      uint32_t pb[BK / 8][4], ps[BK / 8][4];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        split(sc[4 * j], pb[j][0], ps[j][0]);
        split(sc[4 * j + 2], pb[j][1], ps[j][1]);
        split(sc[4 * j + 1], pb[j][2], ps[j][2]);
        split(sc[4 * j + 3], pb[j][3], ps[j][3]);
      }
      reg_fence(o);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const uint64_t vd_b = smem_desc(Vb(buf) + 256 * j, 128, C::V_SBO);
        const uint64_t vd_s = smem_desc(Vsm(buf) + 256 * j, 128, C::V_SBO);
        wgmma_rs<D>(o, ps[j], vd_b, 1);
        wgmma_rs<D>(o, pb[j], vd_s, 1);
        wgmma_rs<D>(o, pb[j], vd_b, 1);
      }
      wgmma_commit();
    }

    // the next tile's split overlaps this tile's P V
    if (kt < kt_end) {
      split_tile(buf ^ 1);
      fence_async_shared();
    }
    wgmma_wait<0>();
    reg_fence(o);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int r = rw + 8 * h;
    if (r >= a.s) continue;
    const float ls = fmaxf(l[h], 1e-30f);
    float* orow = a.out + (((long long)bb * a.s + r) * a.h + hh) * D;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<float2*>(orow + 8 * c + 2 * t) =
          make_float2(o[4 * c + 2 * h] / ls, o[4 * c + 2 * h + 1] / ls);
    if (t == 0)
      a.lse[((long long)bb * a.h + hh) * a.s + r] =
          m[h] * 0.6931471805599453f + logf(ls);
  }
}

template <typename T, int D>
int launch(const Args& a, cudaStream_t stream) {
  auto kernel = flash_attn_kernel<T, D>;
  constexpr int smem = Cfg<D>::SMEM;
  // set once per template instance: the attribute outlives the launch
  static bool allowed = false;
  if (!allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    allowed = true;
  }
  const int n_qt = (a.s + Cfg<D>::BQ - 1) / Cfg<D>::BQ;
  if (n_qt > 65535) return (int)cudaErrorInvalidValue;
  kernel<<<dim3(a.h, a.b, n_qt), Cfg<D>::THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p, int elem, long long s0, long long s1,
               long long s2) {
  const long long step = 16 / elem;
  return (uintptr_t)p % 16 == 0 && s0 % step == 0 && s1 % step == 0 &&
         s2 % step == 0;
}

}  // namespace

// C entry point, called through ctypes. Launches on `stream` and returns
// cudaGetLastError() (0 on success); it neither synchronises nor allocates.
extern "C" int flash_attn(const void* q, const void* k, const void* v,
                          float* out, float* lse, void* stream, int b, int s,
                          int t, int h, int kv, int d, int causal, int window,
                          int bf16, long long sqb, long long sqs,
                          long long sqh, long long skb, long long sks,
                          long long skh, long long svb, long long svs,
                          long long svh) {
  const int elem = bf16 ? 2 : 4;
  if (b < 1 || b > 65535 || s < 1 || t < 1 || h < 1 || h > 65535 || kv < 1 ||
      h % kv != 0 || window < 0 || !aligned16(q, elem, sqb, sqs, sqh) ||
      !aligned16(k, elem, skb, sks, skh) || !aligned16(v, elem, svb, svs, svh))
    return (int)cudaErrorInvalidValue;
  Args a{q,   k,   v,   out, lse, b,   s,   t,   h,   kv,  causal, window,
         (float)(1.4426950408889634 / sqrt((double)d)),
         sqb, sqs, sqh, skb, sks, skh, svb, svs, svh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      return bf16 ? launch<__nv_bfloat16, 32>(a, st) : launch<float, 32>(a, st);
    case 64:
      return bf16 ? launch<__nv_bfloat16, 64>(a, st) : launch<float, 64>(a, st);
    case 80:
      return bf16 ? launch<__nv_bfloat16, 80>(a, st) : launch<float, 80>(a, st);
    case 128:
      return bf16 ? launch<__nv_bfloat16, 128>(a, st) : launch<float, 128>(a, st);
    case 256:
      return bf16 ? launch<__nv_bfloat16, 256>(a, st) : launch<float, 256>(a, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
