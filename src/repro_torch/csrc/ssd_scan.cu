// The Mamba-2 SSD chunked scan, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel `ssd_scan_pallas` (src/repro/kernels/ssd_scan/
// kernel.py, body `_ssd_kernel`), which walks the chunks of every (batch,
// head) in order with the (N, P) state in VMEM. Per chunk of L tokens,
// with a = dt * A and cs = cumsum(a) over the chunk:
//
//   y_i   = sum_{l <= i} (C_i . B_l) exp(cs_i - cs_l) x_l dt_l
//           + exp(cs_i) C_i . state_in
//   state = exp(cs_L) state_in + sum_l B_l exp(cs_L - cs_l) (x_l dt_l)^T
//
// and the final state is written out on request.
//
// The design is the SSD decomposition of Mamba-2 (arXiv:2405.21060, sec.
// 6): only the state carries across chunks, so everything else runs in
// parallel over (batch, head, chunk). One call launches four kernels on
// the caller's stream:
//   1. ssd_cb_kernel: C.B^T of every (batch, chunk, group), once, shared by
//      the group's heads (the 64 x 64 tiles on and below the diagonal),
//      into a scratch (b, c, g, L, L) float32;
//   2. ssd_state_kernel: each chunk's own state contribution B^T diag(dt
//      exp(cs_L - cs)) x, an (n x L) . (L x p) product per (batch, head,
//      chunk), into a scratch (b, h, c', n, p), and the chunk's total
//      cs_L; c' = c - 1 chunks (the last chunk's state is read by nothing)
//      or c when the final state is asked for;
//   3. ssd_prefix_kernel: the pass across chunks, in place and elementwise:
//      slot j becomes the state after chunk j, exp(cs_L) state + own part;
//      the last slot is the final state;
//   4. ssd_out_kernel: y per (batch, head, chunk, 64 rows, p tile) as ONE
//      product [scores | exp(cs_i) C] . [x dt ; state_in] over a depth of
//      up to L + n, the scores read from the C.B^T scratch and decayed
//      and masked as they are loaded into the mma fragments.
// At b=8, s=512, h=24, p=64, g=1, n=128, L=128 that is 96 + 1,152 + 1,536
// + 1,536 blocks of 8 warps and ~38 KB of shared memory each, two
// resident on an SM (registers allow two).
//
// What bounds it on the card: operations. The products run on the tensor
// cores with `mma.sync.m16n8k8` TF32 at float32 accuracy by the 3xTF32
// split: a = big + small with big = a truncated to TF32 and small = a -
// big rounded to TF32, and a.b ~ small.big + big.small + big.big,
// accumulated in float32 (one TF32 pass keeps ~3 decimal digits, too few
// for atol 1e-4 at |y| ~ 10). Each block runs a K loop over tiles of 32
// with the next tile's operands staged by `cp.async` (zero-filled past
// the chunk, the sequence, n and the row) while the current tile is
// multiplied; rows of shared memory are padded (36 floats for row-major
// A tiles, p tile + 8 for k-major tiles) so that every fragment load of
// a warp falls in distinct banks. The splits and the decay's exp are
// redone by each warp that loads an operand; they, not the mma or the
// loads, set the pace.
//
// The chunk's cumsum of dt * A is taken in float64 by warp shuffles:
// exp(cs_i - cs_l) from float32 sums of |cs| ~ 100 (chunk 128, strong
// decay) would lose ~1e-5 of every decay factor to cancellation, 10x the
// 1e-4 tolerance against the sequential recurrence at |y| ~ 10. exp is
// evaluated only where l <= i, so nothing overflows above the diagonal.
//
// Layouts: x (b, s, h, p) float32 or bfloat16; dt (b, s, h); A (h,);
// B, C (b, s, g, n), all float32 and read through strides with unit
// stride in the last dimension; x, B and C 16-byte aligned with strides
// of whole 16 bytes (the wrapper checks). y (b, s, h, p) in x's type,
// contiguous; state (b, h, n, p) float32, contiguous. Steps past s are
// dt = 0 steps (the padding of the JAX wrapper, without a copy).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

using tf32x3::cp16;
using tf32x3::cp_commit;
using tf32x3::cp_wait;
using tf32x3::mma3;

constexpr int THREADS = 256;   // 8 warps: 4 along the rows x 2 along the columns
constexpr int BM = 64;         // rows of a block's output tile
constexpr int KT = 32;         // depth of a K tile: 4 mma steps of 8
constexpr int STAGES = 2;      // K tiles in shared memory: double-buffered
constexpr int AS = KT + 4;     // padded row of a row-major A tile
constexpr int MAX_L = 128;     // the longest chunk

struct Args {
  const void* x;
  const float* dt;
  const float* A;
  const float* B;
  const float* C;
  void* y;
  float* state_out;
  float* cb;      // (b, c, g, L, L)   C.B^T per chunk and group
  float* st;      // (b, h, cs_n, n, p) chunk states
  float* tot;     // (b, h, cs_n)       cs_L of each chunk
  int b, s, h, p, g, n, L, c, cs_n;
  long long sxb, sxs, sxh, sdb, sds, sdh, sBb, sBs, sBg, sCb, sCs, sCg;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The K loop over nk tiles: `load(stage, kt)` stages tile kt's operands
// by cp.async, STAGES - 1 tiles ahead of `compute(stage, kt)`. One barrier
// a tile: past it, tile kt has landed and every warp is done with tile
// kt - 1, whose stage the next load refills. stage_ahead issues the first
// loads (a block may work on other things before run_tiles).
template <class Load>
__device__ __forceinline__ void stage_ahead(int nk, Load load) {
#pragma unroll
  for (int kt = 0; kt < STAGES - 1; ++kt) {
    if (kt < nk) load(kt, kt);
    cp_commit();
  }
}
template <class Load, class Compute>
__device__ __forceinline__ void run_tiles(int nk, Load load,
                                          Compute compute) {
  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<STAGES - 2>();
    __syncthreads();
    const int next = kt + STAGES - 1;
    if (next < nk) load(next % STAGES, next);
    cp_commit();
    compute(kt % STAGES, kt);
  }
}

// dts[l] = dt of the chunk's step l (0 past the chunk and past s) and
// cs[l] = cumsum(dt * A) over the chunk in float64 (constant past L).
__device__ void chunk_cumsum(const Args& a, int bb, int hh, int cc,
                             float* dts, double* cs, double* wsum) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  double v = 0.0;
  if (tid < MAX_L) {   // warps 0-3 whole
    const int t = cc * a.L + tid;
    const float d = tid < a.L && t < a.s
                        ? a.dt[bb * a.sdb + t * a.sds + hh * a.sdh]
                        : 0.f;
    dts[tid] = d;
    v = (double)(d * a.A[hh]);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    if (lane == 31) wsum[warp] = v;
  }
  __syncthreads();
  if (tid < MAX_L) {
    for (int w = 0; w < warp; ++w) v += wsum[w];
    cs[tid] = v;
  }
  __syncthreads();
}

// 1. C.B^T tile (i tile blockIdx.y, l tile blockIdx.z <= it) of (batch,
// chunk, group) blockIdx.x; depth n.
constexpr int CB_SMEM = STAGES * 2 * BM * AS * sizeof(float);

__global__ void __launch_bounds__(THREADS, 2) ssd_cb_kernel(Args a) {
  const int it = blockIdx.y, lt = blockIdx.z;
  if (lt > it) return;
  extern __shared__ __align__(16) unsigned char smem[];
  auto Cs = reinterpret_cast<float(*)[BM][AS]>(smem);   // C rows i
  auto Bs = Cs + STAGES;                                  // B rows l
  const int bcg = blockIdx.x, gg = bcg % a.g, cc = (bcg / a.g) % a.c;
  const int bb = bcg / a.g / a.c;
  const int L = a.L, t0 = cc * L, i0 = it * BM, l0 = lt * BM;
  const float* Cg = a.C + bb * a.sCb + gg * a.sCg;
  const float* Bg = a.B + bb * a.sBb + gg * a.sBg;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp & 3, wn = warp >> 2, g = lane >> 2, t = lane & 3;

  auto load = [&](int stage, int kt) {
    for (int e = tid; e < BM * (KT / 4); e += THREADS) {
      const int r = e / (KT / 4), q = (e % (KT / 4)) * 4, k = kt * KT + q;
      const int i = i0 + r, l = l0 + r;
      const bool iok = k < a.n && i < L && t0 + i < a.s;
      const bool lok = k < a.n && l < L && t0 + l < a.s;
      cp16(&Cs[stage][r][q], iok ? Cg + (t0 + i) * a.sCs + k : Cg, iok);
      cp16(&Bs[stage][r][q], lok ? Bg + (t0 + l) * a.sBs + k : Bg, lok);
    }
  };

  float acc[4][4] = {};
  const int nk = (a.n + KT - 1) / KT;
  stage_ahead(nk, load);
  run_tiles(nk, load, [&](int st, int) {
#pragma unroll
    for (int k8 = 0; k8 < KT; k8 += 8) {
      const int r = wm * 16 + g;
      const float av[4] = {Cs[st][r][k8 + t], Cs[st][r + 8][k8 + t],
                           Cs[st][r][k8 + t + 4], Cs[st][r + 8][k8 + t + 4]};
      float bv[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = wn * 32 + j * 8 + g;
        bv[j][0] = Bs[st][col][k8 + t];
        bv[j][1] = Bs[st][col][k8 + t + 4];
      }
      mma3<4>(acc, av, bv);
    }
  });

  float* out = a.cb + (long long)bcg * L * L;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int l = l0 + wn * 32 + j * 8 + 2 * t;   // even, L % 16 == 0
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = i0 + wm * 16 + g + 8 * half;
      if (i < L && l < L)
        store2(out + (long long)i * L + l, acc[j][2 * half],
               acc[j][2 * half + 1]);
    }
  }
}

// 2. The own state contribution of chunk blockIdx.x % cs_n of (batch,
// head) blockIdx.x / cs_n: rows nn (tile blockIdx.y), columns p (tile
// blockIdx.z), depth L: S = B^T diag(dt exp(cs_L - cs)) x.
template <typename T, int BN>
constexpr int state_smem() {
  return STAGES * KT * ((BM + 8) * sizeof(float) + (BN + 8) * sizeof(T));
}

template <typename T, int BN>
__global__ void __launch_bounds__(THREADS, 2) ssd_state_kernel(Args a) {
  constexpr int NT = BN / 16, BS = BM + 8, XS = BN + 8, XV = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  auto Bt = reinterpret_cast<float(*)[KT][BS]>(smem);   // B rows l: A = B^T
  auto Xs = reinterpret_cast<T(*)[KT][XS]>(Bt + STAGES);  // x rows l
  __shared__ double cs[MAX_L];
  __shared__ float w[MAX_L];
  __shared__ double wsum[4];
  const int slot = blockIdx.x, cc = slot % a.cs_n, bh = slot / a.cs_n;
  const int hh = bh % a.h, bb = bh / a.h, gg = hh / (a.h / a.g);
  const int nn0 = blockIdx.y * BM, p0 = blockIdx.z * BN;
  const int L = a.L, t0 = cc * L;
  const float* Bg = a.B + bb * a.sBb + gg * a.sBg;
  const T* xg = static_cast<const T*>(a.x) + bb * a.sxb + hh * a.sxh + p0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp & 3, wn = warp >> 2, g = lane >> 2, t = lane & 3;

  auto load = [&](int stage, int kt) {
    for (int e = tid; e < KT * (BM / 4); e += THREADS) {
      const int r = e / (BM / 4), q = (e % (BM / 4)) * 4;
      const int l = kt * KT + r, nn = nn0 + q;
      const bool ok = l < L && t0 + l < a.s && nn < a.n;
      cp16(&Bt[stage][r][q], ok ? Bg + (t0 + l) * a.sBs + nn : Bg, ok);
    }
    for (int e = tid; e < KT * (BN / XV); e += THREADS) {
      const int r = e / (BN / XV), q = (e % (BN / XV)) * XV;
      const int l = kt * KT + r;
      const bool ok = l < L && t0 + l < a.s;
      cp16(&Xs[stage][r][q], ok ? xg + (t0 + l) * a.sxs + q : xg, ok);
    }
  };

  const int nk = (L + KT - 1) / KT;
  stage_ahead(nk, load);
  chunk_cumsum(a, bb, hh, cc, w, cs, wsum);
  if (tid < MAX_L) w[tid] *= expf((float)(cs[L - 1] - cs[tid]));
  if (tid == 0 && blockIdx.y == 0 && blockIdx.z == 0)
    a.tot[slot] = (float)cs[L - 1];

  float acc[NT][4] = {};
  run_tiles(nk, load, [&](int st, int kt) {
#pragma unroll
    for (int k8 = 0; k8 < KT; k8 += 8) {
      const int r = wm * 16 + g, ka = k8 + t, kb = ka + 4;
      const float av[4] = {Bt[st][ka][r], Bt[st][ka][r + 8], Bt[st][kb][r],
                           Bt[st][kb][r + 8]};
      const float wa = w[kt * KT + ka], wb = w[kt * KT + kb];
      float bv[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = wn * (BN / 2) + j * 8 + g;
        bv[j][0] = to_f32(Xs[st][ka][col]) * wa;
        bv[j][1] = to_f32(Xs[st][kb][col]) * wb;
      }
      mma3<NT>(acc, av, bv);
    }
  });

  float* out = a.st + (long long)slot * a.n * a.p + p0;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = wn * (BN / 2) + j * 8 + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int nn = nn0 + wm * 16 + g + 8 * half;
      if (nn < a.n)
        store2(out + (long long)nn * a.p + col, acc[j][2 * half],
               acc[j][2 * half + 1]);
    }
  }
}

// 3. Across chunks, for (batch, head) blockIdx.x and 4 state elements a
// thread: slot j <- exp(cs_L of chunk j) slot j-1 + slot j, in place; the
// last slot is the final state, copied out on request.
__global__ void __launch_bounds__(THREADS) ssd_prefix_kernel(Args a) {
  const long long np = (long long)a.n * a.p;
  const long long e = ((long long)blockIdx.y * THREADS + threadIdx.x) * 4;
  if (e >= np) return;
  const int bh = blockIdx.x;
  float* base = a.st + (long long)bh * a.cs_n * np + e;
  float4 run = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j = 0; j < a.cs_n; ++j) {
    const float d = expf(a.tot[bh * a.cs_n + j]);
    float4* sp = reinterpret_cast<float4*>(base + j * np);
    const float4 v = *sp;
    run = make_float4(d * run.x + v.x, d * run.y + v.y, d * run.z + v.z,
                      d * run.w + v.w);
    *sp = run;
  }
  if (a.state_out != nullptr)
    *reinterpret_cast<float4*>(a.state_out + bh * np + e) = run;
}

// 4. y of (batch, head, chunk) blockIdx.x, rows of tile blockIdx.y,
// columns of p tile blockIdx.z: depth l < min(L, last row + 1) over the
// decayed scores and x dt, then depth n over exp(cs_i) C and the state
// entering the chunk (none for the first chunk).
template <typename T, int BN>
__global__ void __launch_bounds__(THREADS, 2) ssd_out_kernel(Args a) {
  constexpr int NT = BN / 16, XS = BN + 8, XV = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  auto As = reinterpret_cast<float(*)[BM][AS]>(smem);      // C.B^T or C rows i
  auto Bsm = reinterpret_cast<float(*)[KT][XS]>(As + STAGES);
  // ... x rows l (as T) or state rows nn
  __shared__ double cs[MAX_L];
  __shared__ float dts[MAX_L];
  __shared__ double wsum[4];
  const int bhc = blockIdx.x, cc = bhc % a.c, bh = bhc / a.c;
  const int hh = bh % a.h, bb = bh / a.h, gg = hh / (a.h / a.g);
  const int i0 = blockIdx.y * BM, p0 = blockIdx.z * BN;
  const int L = a.L, t0 = cc * L;
  const float* cbg = a.cb + ((long long)(bb * a.c + cc) * a.g + gg) * L * L;
  const float* Cg = a.C + bb * a.sCb + gg * a.sCg;
  const T* xg = static_cast<const T*>(a.x) + bb * a.sxb + hh * a.sxh + p0;
  const float* sg =
      cc > 0 ? a.st + ((long long)bh * a.cs_n + cc - 1) * a.n * a.p + p0
             : a.st;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp & 3, wn = warp >> 2, g = lane >> 2, t = lane & 3;
  const int nkd = (min(L, i0 + BM) + KT - 1) / KT;
  const int nk = nkd + (cc > 0 ? (a.n + KT - 1) / KT : 0);

  auto load = [&](int stage, int kt) {
    if (kt < nkd) {
      const int k0 = kt * KT;
      for (int e = tid; e < BM * (KT / 4); e += THREADS) {
        const int r = e / (KT / 4), q = (e % (KT / 4)) * 4;
        const int i = i0 + r, l = k0 + q;
        const bool ok = i < L && l < L;
        cp16(&As[stage][r][q], ok ? cbg + (long long)i * L + l : cbg, ok);
      }
      T* X = reinterpret_cast<T*>(&Bsm[stage][0][0]);
      for (int e = tid; e < KT * (BN / XV); e += THREADS) {
        const int r = e / (BN / XV), q = (e % (BN / XV)) * XV, l = k0 + r;
        const bool ok = l < L && t0 + l < a.s;
        cp16(X + r * XS + q, ok ? xg + (t0 + l) * a.sxs + q : xg, ok);
      }
    } else {
      const int k0 = (kt - nkd) * KT;
      for (int e = tid; e < BM * (KT / 4); e += THREADS) {
        const int r = e / (KT / 4), q = (e % (KT / 4)) * 4;
        const int i = i0 + r, nn = k0 + q;
        const bool ok = i < L && t0 + i < a.s && nn < a.n;
        cp16(&As[stage][r][q], ok ? Cg + (t0 + i) * a.sCs + nn : Cg, ok);
      }
      for (int e = tid; e < KT * (BN / 4); e += THREADS) {
        const int r = e / (BN / 4), q = (e % (BN / 4)) * 4, nn = k0 + r;
        const bool ok = nn < a.n;
        cp16(&Bsm[stage][r][q], ok ? sg + (long long)nn * a.p + q : sg, ok);
      }
    }
  };

  stage_ahead(nk, load);
  chunk_cumsum(a, bb, hh, cc, dts, cs, wsum);
  const int r = wm * 16 + g, ia = i0 + r, ib = ia + 8;   // < MAX_L
  const double cs_a = cs[ia], cs_b = cs[ib];
  const float ecs_a = expf((float)cs_a), ecs_b = expf((float)cs_b);

  float acc[NT][4] = {};
  run_tiles(nk, load, [&](int st, int kt) {
    if (kt < nkd) {
      const T* X = reinterpret_cast<const T*>(&Bsm[st][0][0]);
#pragma unroll
      for (int k8 = 0; k8 < KT; k8 += 8) {
        const int la = kt * KT + k8 + t, lb = la + 4;
        // the warp's rows end at i0 + wm * 16 + 15: past it, all masked
        if (kt * KT + k8 > i0 + wm * 16 + 15) break;
        // the decay e^x, x <= 0, by the fast exp: its absolute error,
        // e^x (2 + 1.2 |x|) 2^-23 <= 3e-7, is far inside the tolerance
        float av[4];
        av[0] = la <= ia
                    ? As[st][r][k8 + t] * __expf((float)(cs_a - cs[la]))
                    : 0.f;
        av[1] = la <= ib
                    ? As[st][r + 8][k8 + t] * __expf((float)(cs_b - cs[la]))
                    : 0.f;
        av[2] = lb <= ia
                    ? As[st][r][k8 + t + 4] * __expf((float)(cs_a - cs[lb]))
                    : 0.f;
        av[3] = lb <= ib ? As[st][r + 8][k8 + t + 4] *
                               __expf((float)(cs_b - cs[lb]))
                         : 0.f;
        const float da = dts[la], db = dts[lb];
        float bv[NT][2];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int col = wn * (BN / 2) + j * 8 + g;
          bv[j][0] = to_f32(X[(k8 + t) * XS + col]) * da;
          bv[j][1] = to_f32(X[(k8 + t + 4) * XS + col]) * db;
        }
        mma3<NT>(acc, av, bv);
      }
    } else {
#pragma unroll
      for (int k8 = 0; k8 < KT; k8 += 8) {
        const float av[4] = {As[st][r][k8 + t] * ecs_a,
                             As[st][r + 8][k8 + t] * ecs_b,
                             As[st][r][k8 + t + 4] * ecs_a,
                             As[st][r + 8][k8 + t + 4] * ecs_b};
        float bv[NT][2];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int col = wn * (BN / 2) + j * 8 + g;
          bv[j][0] = Bsm[st][k8 + t][col];
          bv[j][1] = Bsm[st][k8 + t + 4][col];
        }
        mma3<NT>(acc, av, bv);
      }
    }
  });

  T* yb = static_cast<T*>(a.y) + ((long long)bb * a.s * a.h + hh) * a.p + p0;
  const long long y_row = (long long)a.h * a.p;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = ia + 8 * half, tt = t0 + i;
    if (i < L && tt < a.s) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = wn * (BN / 2) + j * 8 + 2 * t;
        store2(yb + tt * y_row + col, acc[j][2 * half],
               acc[j][2 * half + 1]);
      }
    }
  }
}

template <int BN>
constexpr int out_smem() {
  return STAGES * (BM * AS + KT * (BN + 8)) * sizeof(float);
}

// Every kernel's dynamic shared memory stays under the 48 KB that needs no
// opt-in (36,864 bytes at p tile 64).
static_assert(CB_SMEM <= 48 * 1024 && out_smem<64>() <= 48 * 1024 &&
                  state_smem<float, 64>() <= 48 * 1024,
              "shared memory past 48 KB needs cudaFuncSetAttribute");

template <typename T, int BN>
int launch(const Args& a, cudaStream_t stream) {
  const int row_tiles = (a.L + BM - 1) / BM;
  ssd_cb_kernel<<<dim3(a.b * a.c * a.g, row_tiles, row_tiles), THREADS,
                  CB_SMEM, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (a.cs_n > 0) {
    ssd_state_kernel<T, BN><<<dim3(a.b * a.h * a.cs_n, (a.n + BM - 1) / BM,
                                   a.p / BN),
                              THREADS, state_smem<T, BN>(), stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const long long quads = (long long)a.n * a.p / 4;
    ssd_prefix_kernel<<<dim3(a.b * a.h,
                             (unsigned)((quads + THREADS - 1) / THREADS)),
                        THREADS, 0, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  ssd_out_kernel<T, BN><<<dim3(a.b * a.h * a.c, row_tiles, a.p / BN), THREADS,
                          out_smem<BN>(), stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// One scan: four launches on `stream`; returns 0 or the first CUDA error.
// The caller allocates the scratch: cb (b, c, g, chunk, chunk), states
// (b, h, c', n, p) and tot (b, h, c') float32, c = ceil(s / chunk), c' =
// c with a final state and c - 1 without.
extern "C" int ssd_scan(const void* x, const float* dt, const float* A,
                        const float* B, const float* C, void* y,
                        float* state_out, float* cb, float* states,
                        float* tot, void* stream, int b, int s, int h, int p,
                        int g, int n, int chunk, int x_bf16, long long sxb,
                        long long sxs, long long sxh, long long sdb,
                        long long sds, long long sdh, long long sBb,
                        long long sBs, long long sBg, long long sCb,
                        long long sCs, long long sCg) {
  if (b < 1 || s < 1 || h < 1 || g < 1 || h % g != 0 || n < 4 || n % 4 ||
      chunk < 16 || chunk % 16 || chunk > MAX_L ||
      !(p == 32 || p % 64 == 0))
    return (int)cudaErrorInvalidValue;
  const int c = (s + chunk - 1) / chunk;
  Args a{x,   dt,  A,   B,   C,   y,   state_out, cb,  states, tot,
         b,   s,   h,   p,   g,   n,   chunk,     c,   state_out ? c : c - 1,
         sxb, sxs, sxh, sdb, sds, sdh, sBb,       sBs, sBg,    sCb,
         sCs, sCg};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return p == 32 ? launch<__nv_bfloat16, 32>(a, st)
                   : launch<__nv_bfloat16, 64>(a, st);
  return p == 32 ? launch<float, 32>(a, st) : launch<float, 64>(a, st);
}
