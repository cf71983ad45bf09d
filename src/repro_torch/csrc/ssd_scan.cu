// The Mamba-2 SSD chunked scan, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel `ssd_scan_pallas` (src/repro/kernels/ssd_scan/
// kernel.py, body `_ssd_kernel`). For every (batch, head) the chunks of L
// tokens run in order with the (N, P) float32 state carried across them;
// per chunk, with a = dt * A and cs = cumsum(a) over the chunk:
//
//   y_i   = sum_{l <= i} (C_i . B_l) exp(cs_i - cs_l) x_l dt_l
//           + exp(cs_i) C_i . state
//   state = exp(cs_L) state + sum_l B_l exp(cs_L - cs_l) (x_l dt_l)^T
//
// and the final state is written out on request.
//
// What bounds it on the card: arithmetic. Per (batch, head, chunk) the
// C.B^T scores, the score-times-x product, C.state and the state update
// are ~8 MFLOP on ~50 KB of input, so the float32 units (no TF32: the
// parity tolerance is float32's) are the limit, not HBM. The design:
//   - one block of 256 threads per (batch, head, 64 columns of P); the
//     state stays in shared memory for the whole sequence, so nothing
//     but x, dt, B, C and y crosses HBM;
//   - the chunk's B, C and x*dt live in shared memory, read once from
//     HBM through the caller's strides (the mixer's slices of one
//     projection need no copy); group h / (H/G) of B and C is indexed
//     directly, never repeated per head;
//   - C.B^T is computed in tiles of 32 rows (4 rows per warp, each lane
//     4 columns 32 apart), so chunk 128 with N = 128 fits in 227 KB;
//     tiles above the diagonal are skipped and exp is evaluated only
//     where l <= i;
//   - every product is a register-blocked float32 FMA loop over
//     16-byte shared-memory loads, rows padded by 4 floats so the
//     loads of a warp fall in distinct banks;
//   - the chunk's cumsum of dt * A is kept in float64: exp(cs_i - cs_l)
//     from float32 sums of |cs| ~ 100 (chunk 128, strong decay) would
//     lose ~1e-5 of every decay factor to cancellation, 10x the 1e-4
//     tolerance against the sequential recurrence at |y| ~ 10.
// wgmma, TMA and computing C.B^T once per group instead of once per head
// are later work.
//
// Layouts: x (b, s, h, p) float32 or bfloat16; dt (b, s, h); A (h,);
// B, C (b, s, g, n), all float32 and read through strides with unit
// stride in the last dimension. y (b, s, h, p) in x's type, contiguous;
// state (b, h, n, p) float32, contiguous. Steps past s are dt = 0 steps
// (the padding of the JAX wrapper, without a copy).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;   // 8 warps
constexpr int ROWS = 32;       // chunk rows per score tile: 4 per warp
constexpr int RS = ROWS + 4;   // padded row of the transposed score tile
constexpr int MAXQ = 4;        // state update: n quads per warp (N <= 128)

struct Args {
  const void* x;
  const float* dt;
  const float* A;
  const float* B;
  const float* C;
  void* y;
  float* state_out;
  int b, s, h, p, g, n, chunk;
  long long sxb, sxs, sxh, sdb, sds, sdh, sBb, sBs, sBg, sCb, sCs, sCg;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// T: the type of x and y. PT: columns of P per block (32 or 64).
template <typename T, int PT>
__global__ void __launch_bounds__(THREADS, 1) ssd_scan_kernel(Args a) {
  constexpr int NC = PT / 32;   // columns per lane
  const int L = a.chunk, N = a.n, NS = a.n + 4;
  const int H = a.h, S = a.s;

  extern __shared__ float4 smem_f4[];
  float* smem = reinterpret_cast<float*>(smem_f4);
  float* Cs = smem;                 // (L, NS)  C of the chunk
  float* Bs = Cs + L * NS;          // (L, NS)  B of the chunk
  float* Xs = Bs + L * NS;          // (L, PT)  x * dt
  float* St = Xs + L * PT;          // (PT, NS) the state, transposed
  float* Sc = St + PT * NS;         // (L, RS)  a score tile, transposed
  double* cs = reinterpret_cast<double*>(Sc + L * RS);  // (L) cumsum(dt A)
  float* ecs = reinterpret_cast<float*>(cs + L);        // (L) exp(cs)
  float* dec = ecs + L;             // (L)      exp(cs_L - cs); first dt

  const int bh = blockIdx.x, bb = bh / H, hh = bh % H;
  const int p0 = blockIdx.y * PT;
  const int gg = hh / (H / a.g);
  const float Ah = a.A[hh];
  const T* xb = static_cast<const T*>(a.x) + bb * a.sxb + hh * a.sxh + p0;
  const float* dtb = a.dt + bb * a.sdb + hh * a.sdh;
  const float* Bb = a.B + bb * a.sBb + gg * a.sBg;
  const float* Cb = a.C + bb * a.sCb + gg * a.sCg;
  T* yb = static_cast<T*>(a.y) + ((long long)bb * S * H + hh) * a.p + p0;
  const long long y_row = (long long)H * a.p;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  for (int e = tid; e < PT * NS; e += THREADS) St[e] = 0.f;

  const int n_chunks = (S + L - 1) / L;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * L;

    // -- load the chunk: dt, dt * A, B, C --------------------------------
    for (int l = tid; l < L; l += THREADS) {
      const int t = t0 + l;
      const float d = t < S ? dtb[t * a.sds] : 0.f;
      dec[l] = d;
      cs[l] = (double)(d * Ah);
    }
    for (int e = tid; e < L * N; e += THREADS) {
      const int l = e / N, nn = e - l * N, t = t0 + l;
      const bool ok = t < S;
      Cs[l * NS + nn] = ok ? Cb[t * a.sCs + nn] : 0.f;
      Bs[l * NS + nn] = ok ? Bb[t * a.sBs + nn] : 0.f;
    }
    __syncthreads();
    for (int e = tid; e < L * PT; e += THREADS) {
      const int l = e / PT, pp = e - l * PT, t = t0 + l;
      Xs[e] = t < S ? to_f32(xb[t * a.sxs + pp]) * dec[l] : 0.f;
    }
    if (tid == 0) {
      double run = 0.0;
      for (int l = 0; l < L; ++l) {
        run += cs[l];
        cs[l] = run;
      }
    }
    __syncthreads();
    for (int l = tid; l < L; l += THREADS) {
      ecs[l] = expf((float)cs[l]);
      dec[l] = expf((float)(cs[L - 1] - cs[l]));
    }
    __syncthreads();

    // -- y, in tiles of ROWS rows; the state is the chunk's start state --
    for (int r0 = 0; r0 < L; r0 += ROWS) {
      const int ib = r0 + 4 * warp;       // this warp's 4 rows
      const int i_max = ib + 3;
      const bool rows = ib < L;           // warp-uniform (L % 4 == 0)
      // column groups of 32 that hold some l <= i_max
      const int nb = min((L + 31) / 32, i_max / 32 + 1);
      if (rows) {
        float acc[4][4] = {};
        for (int n4 = 0; n4 < N; n4 += 4) {
          float4 cv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            cv[r] = *reinterpret_cast<const float4*>(&Cs[(ib + r) * NS + n4]);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int l = lane + 32 * q;
            if (q < nb && l < L) {
              const float4 bv =
                  *reinterpret_cast<const float4*>(&Bs[l * NS + n4]);
#pragma unroll
              for (int r = 0; r < 4; ++r) acc[r][q] += dot4(cv[r], bv);
            }
          }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int l = lane + 32 * q;
          if (q < nb && l < L) {
            float v[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int i = ib + r;
              v[r] = l <= i ? acc[r][q] * expf((float)(cs[i] - cs[l])) : 0.f;
            }
            *reinterpret_cast<float4*>(&Sc[l * RS + 4 * warp]) =
                make_float4(v[0], v[1], v[2], v[3]);
          }
        }
      }
      __syncthreads();
      if (rows) {
        float yd[4][NC] = {}, yo[4][NC] = {};
        for (int l = 0; l <= i_max; ++l) {
          const float4 sv =
              *reinterpret_cast<const float4*>(&Sc[l * RS + 4 * warp]);
#pragma unroll
          for (int k = 0; k < NC; ++k) {
            const float xv = Xs[l * PT + lane + 32 * k];
            yd[0][k] += sv.x * xv;
            yd[1][k] += sv.y * xv;
            yd[2][k] += sv.z * xv;
            yd[3][k] += sv.w * xv;
          }
        }
        for (int n4 = 0; n4 < N; n4 += 4) {
          float4 cv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            cv[r] = *reinterpret_cast<const float4*>(&Cs[(ib + r) * NS + n4]);
#pragma unroll
          for (int k = 0; k < NC; ++k) {
            const float4 sv = *reinterpret_cast<const float4*>(
                &St[(lane + 32 * k) * NS + n4]);
#pragma unroll
            for (int r = 0; r < 4; ++r) yo[r][k] += dot4(cv[r], sv);
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = ib + r, t = t0 + i;
          if (t < S) {
#pragma unroll
            for (int k = 0; k < NC; ++k)
              from_f32(&yb[t * y_row + lane + 32 * k],
                       yd[r][k] + ecs[i] * yo[r][k]);
          }
        }
      }
      __syncthreads();   // the next tile overwrites Sc
    }

    // -- state <- exp(cs_L) state + sum_l B_l exp(cs_L - cs_l) xdt_l -----
    {
      float acc[MAXQ][4][NC] = {};
      for (int l = 0; l < L; ++l) {
        const float d = dec[l];
        float xd[NC];
#pragma unroll
        for (int k = 0; k < NC; ++k) xd[k] = Xs[l * PT + lane + 32 * k] * d;
#pragma unroll
        for (int j = 0; j < MAXQ; ++j) {
          const int n4 = 4 * (warp + 8 * j);
          if (n4 < N) {
            const float4 bv =
                *reinterpret_cast<const float4*>(&Bs[l * NS + n4]);
#pragma unroll
            for (int k = 0; k < NC; ++k) {
              acc[j][0][k] += bv.x * xd[k];
              acc[j][1][k] += bv.y * xd[k];
              acc[j][2][k] += bv.z * xd[k];
              acc[j][3][k] += bv.w * xd[k];
            }
          }
        }
      }
      const float total = ecs[L - 1];
#pragma unroll
      for (int j = 0; j < MAXQ; ++j) {
        const int n4 = 4 * (warp + 8 * j);
        if (n4 < N) {
#pragma unroll
          for (int k = 0; k < NC; ++k) {
            float4* sp =
                reinterpret_cast<float4*>(&St[(lane + 32 * k) * NS + n4]);
            float4 sv = *sp;
            sv.x = total * sv.x + acc[j][0][k];
            sv.y = total * sv.y + acc[j][1][k];
            sv.z = total * sv.z + acc[j][2][k];
            sv.w = total * sv.w + acc[j][3][k];
            *sp = sv;
          }
        }
      }
    }
    __syncthreads();   // the next chunk overwrites B, C, x * dt
  }

  if (a.state_out != nullptr) {
    for (int e = tid; e < N * PT; e += THREADS) {
      const int nn = e / PT, pp = e - nn * PT;
      a.state_out[((long long)bh * N + nn) * a.p + p0 + pp] = St[pp * NS + nn];
    }
  }
}

template <typename T, int PT>
int launch(const Args& a, size_t smem, cudaStream_t stream) {
  auto kernel = ssd_scan_kernel<T, PT>;
  // The largest dynamic shared memory this instance was allowed so far:
  // it is raised again only when a launch needs more.
  static size_t allowed = 0;
  if (smem > allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    allowed = smem;
  }
  dim3 grid(a.b * a.h, a.p / PT);
  kernel<<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns 0 or the CUDA error of the launch.
extern "C" int ssd_scan(const void* x, const float* dt, const float* A,
                        const float* B, const float* C, void* y,
                        float* state_out, void* stream, int b, int s, int h,
                        int p, int g, int n, int chunk, int x_bf16,
                        long long sxb, long long sxs, long long sxh,
                        long long sdb, long long sds, long long sdh,
                        long long sBb, long long sBs, long long sBg,
                        long long sCb, long long sCs, long long sCg) {
  if (b < 1 || s < 1 || h < 1 || g < 1 || h % g != 0 || n < 4 || n % 4 ||
      n > 4 * 8 * MAXQ || chunk < 4 || chunk % 4 || chunk > 128 ||
      !(p == 32 || p % 64 == 0))
    return (int)cudaErrorInvalidValue;
  const int pt = p == 32 ? 32 : 64;
  const size_t smem =
      sizeof(float) * ((size_t)2 * chunk * (n + 4) + (size_t)chunk * pt +
                       (size_t)pt * (n + 4) + (size_t)chunk * RS + 4 * chunk);
  Args a{x,  dt, A,     B,   C,   y,   state_out, b,   s,   h,
         p,  g,  n,     chunk, sxb, sxs, sxh,     sdb, sds, sdh,
         sBb, sBs, sBg, sCb, sCs, sCg};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    return pt == 32 ? launch<__nv_bfloat16, 32>(a, smem, st)
                    : launch<__nv_bfloat16, 64>(a, smem, st);
  }
  return pt == 32 ? launch<float, 32>(a, smem, st)
                  : launch<float, 64>(a, smem, st);
}
