// Derivatives of sliding-window causal attention for Hopper (sm_90a): the
// backward (dq, then dk and dv) and the forward-mode tangent (jvp).
//
// The layout is the forward's (csrc/swa_attention.cu): q, dq and the
// output's cotangent g: (B, T, H, hd); k, v, dk, dv: (B, T, K, hd); all
// contiguous, f32 or bf16 storage, f32 arithmetic.  Query t attends to the
// keys t - window ... t (window + 1 keys, clipped at 0), s_tj = scale q_t.k_j
// with scale = 1/sqrt(hd), P = softmax_j(s), O = P V.  Query head h reads kv
// head h / (H / K): MQA/GQA K/V are read in place, never repeated.  Any T,
// window >= 0 and hd <= 256.
//
// Replaces no TPU kernel: the reference trains through the jnp
// windowed_attention (src/repro/models/layers.py:232), which JAX
// differentiates itself; the port runs the forward as a hand-written kernel
// on the card, so its derivatives are hand-written kernels too.
//
//   dq kernel:   one block per (64-query tile, head, batch row).  Pass 1
//                walks the band's key tiles with an online softmax and
//                forms each row's log-sum-exp and D_t = sum_j P_tj dP_tj
//                (dP = g V^T; D = rowsum(g o O) computed from P in f32, so
//                a bf16-stored O never enters it).  Pass 2 walks them again:
//                dS = P (dP - D), dq = scale dS K.  LSE and D go out as a
//                (B, H, T) f32 side output for the dk/dv kernel.
//   dk/dv kernel: one block per (64-key tile, kv head, batch row).  It walks
//                the queries t in [s, s + window] of every head of its kv
//                group, recomputes P from the side output, and sums
//                dv = P^T g and dk = scale dS^T q in registers: no atomics.
//   jvp kernel:  one block per (64-query tile, head, batch row), one online
//                softmax pass carrying m, l, A = sum p v, B = sum p ds and
//                F = sum p (ds v + dv), with ds_tj = scale (dq_t.k_j +
//                q_t.dk_j); then dO = (F - (B / l) A) / l.
//
// What bounds them on this card: operations.  At recurrentgemma-9b's
// training shape (B 2, T 4096, H 16, K 1, hd 256, window 2048) the backward
// does about 2.5x the forward's 4 B H hd sum_t (min(t, window) + 1) flops
// (0.52 TFLOP useful) against 0.1 GB of inputs and outputs.  These first
// kernels do that work in f32 on the CUDA cores (67 TFLOP/s), not on the
// tensor cores; wgmma/TMA versions are later work.  The design:
//   * 256 threads as a 16 x 16 grid.  Thread (ty, tx) owns the block's rows
//     ty + 16 i (i < 4) and, of each walked tile, the columns tx + 16 jj;
//     its hd-wide accumulators hold dims g * 64 + tx * 4 + c;
//   * hd-wide tiles sit in shared memory as f32, row-major with a row
//     stride of hd_pad + 4 floats (float4 loads of 16 neighbouring rows hit
//     distinct banks); head dims are zero-padded to 64, 128 or 256 and rows
//     past T zero-filled, so the ragged edge is masked here;
//   * walked tiles are 64 rows (32 at hd 256, to stay in 227 KB);
//   * a masked pair gets probability 0 explicitly; sums run in a fixed
//     order, so two launches on the same inputs give the same bits.
//
// The kernels allocate nothing and launch on the stream they are given.
// Plain C interface (ctypes); each launcher returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;              // rows a block owns
constexpr int kThreads = 256;          // 16 x 16
constexpr float kNeg = -1e30f;

template <int HD>
struct Geo {
  static constexpr int kWalk = HD > 128 ? 32 : 64;   // rows of a walked tile
  static constexpr int kNJ = kWalk / 16;             // columns a thread owns
  static constexpr int kLd = HD + 4;                 // hd-wide tile row stride
  static constexpr int kLdS = kWalk + 4;             // score tile row stride
  static constexpr int kDims = HD / 16;              // accumulator dims
  static constexpr int kRowTile = kRows * kLd;       // floats
  static constexpr int kWalkTile = kWalk * kLd;
  static constexpr int kScoreTile = kRows * kLdS;
};

template <class T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <class T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

// rows p0 .. p0 + n - 1 of one head of a (B, T, heads, hd) tensor (src at
// (b, 0, head, 0), row stride `row`) into dst[n][HD + 4] as f32
template <class T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int p0,
                                          int n, int seq, long long row,
                                          int hd) {
  for (int idx = threadIdx.x; idx < n * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    const int t = p0 + r;
    dst[r * (HD + 4) + d] =
        (t < seq && d < hd) ? to_f32(src[(long long)t * row + d]) : 0.f;
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// x[i][jj] = A[ty + 16 i] . B[tx + 16 jj] and y[i][jj] = C[ty + 16 i] .
// D[tx + 16 jj] over the HD dims: two score tiles in one pass
template <int HD>
__device__ __forceinline__ void two_dots(const float* A, const float* Bm,
                                         const float* C, const float* Dm,
                                         float (&x)[4][Geo<HD>::kNJ],
                                         float (&y)[4][Geo<HD>::kNJ]) {
  using G = Geo<HD>;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < G::kNJ; ++jj) x[i][jj] = y[i][jj] = 0.f;
#pragma unroll 2
  for (int d = 0; d < HD; d += 4) {
    float4 a[4], c[4], b[G::kNJ], e[G::kNJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = ld4(&A[(ty + 16 * i) * G::kLd + d]);
      c[i] = ld4(&C[(ty + 16 * i) * G::kLd + d]);
    }
#pragma unroll
    for (int jj = 0; jj < G::kNJ; ++jj) {
      b[jj] = ld4(&Bm[(tx + 16 * jj) * G::kLd + d]);
      e[jj] = ld4(&Dm[(tx + 16 * jj) * G::kLd + d]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < G::kNJ; ++jj) {
        x[i][jj] = dot4(a[i], b[jj], x[i][jj]);
        y[i][jj] = dot4(c[i], e[jj], y[i][jj]);
      }
  }
}

// s[i][jj] = Q[ty + 16 i] . K[tx + 16 jj] and ds[i][jj] = TQ[ty + 16 i] .
// K[tx + 16 jj] + Q[ty + 16 i] . TK[tx + 16 jj]: the jvp's scores and their
// tangents (unscaled) in one pass
template <int HD>
__device__ __forceinline__ void jvp_dots(const float* Q, const float* TQ,
                                         const float* Kt, const float* TK,
                                         float (&s)[4][Geo<HD>::kNJ],
                                         float (&ds)[4][Geo<HD>::kNJ]) {
  using G = Geo<HD>;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < G::kNJ; ++jj) s[i][jj] = ds[i][jj] = 0.f;
#pragma unroll 2
  for (int d = 0; d < HD; d += 4) {
    float4 a[4], c[4], b[G::kNJ], e[G::kNJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = ld4(&Q[(ty + 16 * i) * G::kLd + d]);
      c[i] = ld4(&TQ[(ty + 16 * i) * G::kLd + d]);
    }
#pragma unroll
    for (int jj = 0; jj < G::kNJ; ++jj) {
      b[jj] = ld4(&Kt[(tx + 16 * jj) * G::kLd + d]);
      e[jj] = ld4(&TK[(tx + 16 * jj) * G::kLd + d]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < G::kNJ; ++jj) {
        s[i][jj] = dot4(a[i], b[jj], s[i][jj]);
        ds[i][jj] = dot4(a[i], e[jj], dot4(c[i], b[jj], ds[i][jj]));
      }
  }
}

// acc[i][g*4 + c] += sum_col S[ty + 16 i][col] X[col][g*64 + tx*4 + c]
template <int HD>
__device__ __forceinline__ void acc_product(const float* S, const float* X,
                                            float (&acc)[4][HD / 16]) {
  using G = Geo<HD>;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 4
  for (int col = 0; col < G::kWalk; ++col) {
    float s[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i] = S[(ty + 16 * i) * G::kLdS + col];
#pragma unroll
    for (int g = 0; g < HD / 64; ++g) {
      const float4 x = ld4(&X[col * G::kLd + g * 64 + tx * 4]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][g * 4 + 0] = fmaf(s[i], x.x, acc[i][g * 4 + 0]);
        acc[i][g * 4 + 1] = fmaf(s[i], x.y, acc[i][g * 4 + 1]);
        acc[i][g * 4 + 2] = fmaf(s[i], x.z, acc[i][g * 4 + 2]);
        acc[i][g * 4 + 3] = fmaf(s[i], x.w, acc[i][g * 4 + 3]);
      }
    }
  }
}

__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ bool in_band(int t, int j, int seq, int window) {
  return t < seq && j < seq && j <= t && j >= t - window;
}

// hd-wide accumulators [4][HD/16] of rows ty + 16 i out to a (B, T, heads,
// hd) tensor (dst at (b, 0, head, 0)), each times `mul`
template <class T, int HD>
__device__ __forceinline__ void store_rows(T* dst, const float (&acc)[4][HD / 16],
                                           const float (&mul)[4], int p0,
                                           int seq, long long row, int hd) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = p0 + ty + 16 * i;
    if (t >= seq) continue;
#pragma unroll
    for (int g = 0; g < HD / 64; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int d = g * 64 + tx * 4 + c;
        if (d < hd) dst[(long long)t * row + d] = from_f32<T>(acc[i][g * 4 + c] * mul[i]);
      }
  }
}

template <int HD>
constexpr int dq_smem_bytes() {
  using G = Geo<HD>;
  return (int)sizeof(float) * (2 * G::kRowTile + 2 * G::kWalkTile + G::kScoreTile);
}

template <int HD>
constexpr int dkdv_smem_bytes() {
  using G = Geo<HD>;
  return (int)sizeof(float) *
         (2 * G::kRowTile + 2 * G::kWalkTile + 2 * G::kScoreTile + 2 * G::kWalk);
}

template <int HD>
constexpr int jvp_smem_bytes() {
  using G = Geo<HD>;
  return (int)sizeof(float) * (2 * G::kRowTile + 2 * G::kWalkTile + 2 * G::kScoreTile);
}

// ---------------------------------------------------------------------------
// dq, and the (B, H, T) log-sum-exp and D side outputs
// ---------------------------------------------------------------------------

template <class T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
swa_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ gout,
              T* __restrict__ dq, float* __restrict__ lse_out,
              float* __restrict__ d_out, int seq, int heads, int kv_heads,
              int hd, int window, float scale) {
  using G = Geo<HD>;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Gs = Qs + G::kRowTile;
  float* Ks = Gs + G::kRowTile;
  float* Vs = Ks + G::kWalkTile;
  float* Ss = Vs + G::kWalkTile;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (heads / kv_heads);
  const long long q_row = (long long)heads * hd;
  const long long kv_row = (long long)kv_heads * hd;
  const long long q_base = (long long)b * seq * q_row + (long long)h * hd;
  const long long kv_base = (long long)b * seq * kv_row + (long long)kvh * hd;

  load_tile<T, HD>(Qs, q + q_base, q0, kRows, seq, q_row, hd);
  load_tile<T, HD>(Gs, gout + q_base, q0, kRows, seq, q_row, hd);

  float m[4], l[4], dsum[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
    dsum[i] = 0.f;
  }
  const int q_last = min(q0 + kRows, seq) - 1;
  const int k_begin = max(0, q0 - window);
  float s[4][G::kNJ], dp[4][G::kNJ];

  // pass 1: row max, sum and sum p dP over the band
  for (int k0 = k_begin; k0 <= q_last; k0 += G::kWalk) {
    __syncthreads();
    load_tile<T, HD>(Ks, k + kv_base, k0, G::kWalk, seq, kv_row, hd);
    load_tile<T, HD>(Vs, v + kv_base, k0, G::kWalk, seq, kv_row, hd);
    __syncthreads();
    two_dots<HD>(Qs, Ks, Gs, Vs, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = q0 + ty + 16 * i;
      float mt = kNeg;
#pragma unroll
      for (int jj = 0; jj < G::kNJ; ++jj) {
        s[i][jj] *= scale;
        if (in_band(t, k0 + tx + 16 * jj, seq, window)) mt = fmaxf(mt, s[i][jj]);
      }
      const float m_new = fmaxf(m[i], row_max(mt));
      float ls = 0.f, lds = 0.f;
#pragma unroll
      for (int jj = 0; jj < G::kNJ; ++jj) {
        const float e = in_band(t, k0 + tx + 16 * jj, seq, window)
                            ? expf(s[i][jj] - m_new) : 0.f;
        ls += e;
        lds = fmaf(e, dp[i][jj], lds);
      }
      const float corr = expf(m[i] - m_new);
      l[i] = fmaf(l[i], corr, row_sum(ls));
      dsum[i] = fmaf(dsum[i], corr, row_sum(lds));
      m[i] = m_new;
    }
  }

  float lse[4], dd[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float safe = fmaxf(l[i], 1e-30f);
    lse[i] = m[i] + logf(safe);
    dd[i] = dsum[i] / safe;
    const int t = q0 + ty + 16 * i;
    if (tx == 0 && t < seq) {
      const long long at = ((long long)b * heads + h) * seq + t;
      lse_out[at] = lse[i];
      d_out[at] = dd[i];
    }
  }

  // pass 2: dS = P (dP - D), dq += dS K
  float acc[4][G::kDims];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < G::kDims; ++e) acc[i][e] = 0.f;
  for (int k0 = k_begin; k0 <= q_last; k0 += G::kWalk) {
    __syncthreads();
    load_tile<T, HD>(Ks, k + kv_base, k0, G::kWalk, seq, kv_row, hd);
    load_tile<T, HD>(Vs, v + kv_base, k0, G::kWalk, seq, kv_row, hd);
    __syncthreads();
    two_dots<HD>(Qs, Ks, Gs, Vs, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = q0 + ty + 16 * i;
#pragma unroll
      for (int jj = 0; jj < G::kNJ; ++jj) {
        const float p = in_band(t, k0 + tx + 16 * jj, seq, window)
                            ? expf(s[i][jj] * scale - lse[i]) : 0.f;
        Ss[(ty + 16 * i) * G::kLdS + tx + 16 * jj] = p * (dp[i][jj] - dd[i]);
      }
    }
    __syncthreads();
    acc_product<HD>(Ss, Ks, acc);
  }
  const float mul[4] = {scale, scale, scale, scale};
  store_rows<T, HD>(dq + q_base, acc, mul, q0, seq, q_row, hd);
}

// ---------------------------------------------------------------------------
// dk and dv
// ---------------------------------------------------------------------------

template <class T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
swa_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ gout,
                const float* __restrict__ lse_in,
                const float* __restrict__ d_in, T* __restrict__ dk,
                T* __restrict__ dv, int seq, int heads, int kv_heads, int hd,
                int window, float scale) {
  using G = Geo<HD>;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + G::kRowTile;
  float* Qs = Vs + G::kRowTile;
  float* Gs = Qs + G::kWalkTile;
  float* Ps = Gs + G::kWalkTile;
  float* Ds = Ps + G::kScoreTile;
  float* lse_s = Ds + G::kScoreTile;
  float* dd_s = lse_s + G::kWalk;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k0 = blockIdx.x * kRows;
  const int c = blockIdx.y, b = blockIdx.z;
  const int group = heads / kv_heads;
  const long long q_row = (long long)heads * hd;
  const long long kv_row = (long long)kv_heads * hd;
  const long long kv_base = (long long)b * seq * kv_row + (long long)c * hd;

  load_tile<T, HD>(Ks, k + kv_base, k0, kRows, seq, kv_row, hd);
  load_tile<T, HD>(Vs, v + kv_base, k0, kRows, seq, kv_row, hd);

  float acc_k[4][G::kDims], acc_v[4][G::kDims];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < G::kDims; ++e) acc_k[i][e] = acc_v[i][e] = 0.f;
  float s[4][G::kNJ], dp[4][G::kNJ];
  const int t_last = min(min(k0 + kRows, seq) - 1 + window, seq - 1);

  for (int h = c * group; h < (c + 1) * group; ++h) {
    const long long q_base = (long long)b * seq * q_row + (long long)h * hd;
    const long long side = ((long long)b * heads + h) * seq;
    for (int t0 = k0; t0 <= t_last; t0 += G::kWalk) {
      __syncthreads();
      load_tile<T, HD>(Qs, q + q_base, t0, G::kWalk, seq, q_row, hd);
      load_tile<T, HD>(Gs, gout + q_base, t0, G::kWalk, seq, q_row, hd);
      for (int r = threadIdx.x; r < G::kWalk; r += kThreads) {
        const int t = t0 + r;
        lse_s[r] = t < seq ? lse_in[side + t] : 0.f;
        dd_s[r] = t < seq ? d_in[side + t] : 0.f;
      }
      __syncthreads();
      // s[i][jj] = k_j . q_t and dp[i][jj] = v_j . g_t, key j = k0 + ty +
      // 16 i, query t = t0 + tx + 16 jj
      two_dots<HD>(Ks, Qs, Vs, Gs, s, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = k0 + ty + 16 * i;
#pragma unroll
        for (int jj = 0; jj < G::kNJ; ++jj) {
          const int col = tx + 16 * jj;
          const float p = in_band(t0 + col, j, seq, window)
                              ? expf(s[i][jj] * scale - lse_s[col]) : 0.f;
          Ps[(ty + 16 * i) * G::kLdS + col] = p;
          Ds[(ty + 16 * i) * G::kLdS + col] = p * (dp[i][jj] - dd_s[col]);
        }
      }
      __syncthreads();
      acc_product<HD>(Ps, Gs, acc_v);
      acc_product<HD>(Ds, Qs, acc_k);
    }
  }
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  const float mul[4] = {scale, scale, scale, scale};
  store_rows<T, HD>(dv + kv_base, acc_v, one, k0, seq, kv_row, hd);
  store_rows<T, HD>(dk + kv_base, acc_k, mul, k0, seq, kv_row, hd);
}

// ---------------------------------------------------------------------------
// jvp: the output's tangent for tangents (tq, tk, tv) of (q, k, v)
// ---------------------------------------------------------------------------

template <class T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
swa_jvp_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ tq,
               const T* __restrict__ tk, const T* __restrict__ tv,
               T* __restrict__ tout, int seq, int heads, int kv_heads, int hd,
               int window, float scale) {
  using G = Geo<HD>;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* TQs = Qs + G::kRowTile;
  float* X0 = TQs + G::kRowTile;       // k, then v
  float* X1 = X0 + G::kWalkTile;       // tk, then tv
  float* Ps = X1 + G::kWalkTile;       // p
  float* PDs = Ps + G::kScoreTile;     // p ds

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (heads / kv_heads);
  const long long q_row = (long long)heads * hd;
  const long long kv_row = (long long)kv_heads * hd;
  const long long q_base = (long long)b * seq * q_row + (long long)h * hd;
  const long long kv_base = (long long)b * seq * kv_row + (long long)kvh * hd;

  load_tile<T, HD>(Qs, q + q_base, q0, kRows, seq, q_row, hd);
  load_tile<T, HD>(TQs, tq + q_base, q0, kRows, seq, q_row, hd);

  float acc_a[4][G::kDims], acc_f[4][G::kDims];
  float m[4], l[4], bs[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
    bs[i] = 0.f;
#pragma unroll
    for (int e = 0; e < G::kDims; ++e) acc_a[i][e] = acc_f[i][e] = 0.f;
  }
  const int q_last = min(q0 + kRows, seq) - 1;
  const int k_begin = max(0, q0 - window);
  float s[4][G::kNJ], ds[4][G::kNJ];

  for (int k0 = k_begin; k0 <= q_last; k0 += G::kWalk) {
    __syncthreads();
    load_tile<T, HD>(X0, k + kv_base, k0, G::kWalk, seq, kv_row, hd);
    load_tile<T, HD>(X1, tk + kv_base, k0, G::kWalk, seq, kv_row, hd);
    __syncthreads();
    jvp_dots<HD>(Qs, TQs, X0, X1, s, ds);
    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = q0 + ty + 16 * i;
      float mt = kNeg;
#pragma unroll
      for (int jj = 0; jj < G::kNJ; ++jj) {
        s[i][jj] *= scale;
        if (in_band(t, k0 + tx + 16 * jj, seq, window)) mt = fmaxf(mt, s[i][jj]);
      }
      const float m_new = fmaxf(m[i], row_max(mt));
      float ls = 0.f, lb = 0.f;
#pragma unroll
      for (int jj = 0; jj < G::kNJ; ++jj) {
        const int col = tx + 16 * jj;
        const float p = in_band(t, k0 + col, seq, window)
                            ? expf(s[i][jj] - m_new) : 0.f;
        const float pd = p * (scale * ds[i][jj]);
        ls += p;
        lb += pd;
        Ps[(ty + 16 * i) * G::kLdS + col] = p;
        PDs[(ty + 16 * i) * G::kLdS + col] = pd;
      }
      corr[i] = expf(m[i] - m_new);
      l[i] = fmaf(l[i], corr[i], row_sum(ls));
      bs[i] = fmaf(bs[i], corr[i], row_sum(lb));
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < G::kDims; ++e) {
        acc_a[i][e] *= corr[i];
        acc_f[i][e] *= corr[i];
      }
    }
    __syncthreads();
    load_tile<T, HD>(X0, v + kv_base, k0, G::kWalk, seq, kv_row, hd);
    load_tile<T, HD>(X1, tv + kv_base, k0, G::kWalk, seq, kv_row, hd);
    __syncthreads();
    acc_product<HD>(Ps, X0, acc_a);            // sum p v
    acc_product<HD>(PDs, X0, acc_f);           // + sum p ds v
    acc_product<HD>(Ps, X1, acc_f);            // + sum p tv
  }
  // tout = (F - (B / l) A) / l
  float inv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float safe = fmaxf(l[i], 1e-30f);
    inv[i] = 1.f / safe;
    const float w = bs[i] / safe;
#pragma unroll
    for (int e = 0; e < G::kDims; ++e)
      acc_f[i][e] = fmaf(-w, acc_a[i][e], acc_f[i][e]);
  }
  store_rows<T, HD>(tout + q_base, acc_f, inv, q0, seq, q_row, hd);
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <class K>
int set_smem(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

struct Shape {
  int batch, seq, heads, kv_heads, hd, window;
  float scale;
};

template <class T, int HD>
int launch_dq(const void* q, const void* k, const void* v, const void* g,
              void* dq, float* lse, float* dd, const Shape& s,
              cudaStream_t stream) {
  int err = set_smem(swa_dq_kernel<T, HD>, dq_smem_bytes<HD>());
  if (err) return err;
  const int tiles = (s.seq + kRows - 1) / kRows;
  swa_dq_kernel<T, HD><<<dim3(tiles, s.heads, s.batch), kThreads,
                         dq_smem_bytes<HD>(), stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)g, (T*)dq, lse, dd,
      s.seq, s.heads, s.kv_heads, s.hd, s.window, s.scale);
  return (int)cudaGetLastError();
}

template <class T, int HD>
int launch_dkdv(const void* q, const void* k, const void* v, const void* g,
                const float* lse, const float* dd, void* dk, void* dv,
                const Shape& s, cudaStream_t stream) {
  int err = set_smem(swa_dkdv_kernel<T, HD>, dkdv_smem_bytes<HD>());
  if (err) return err;
  const int tiles = (s.seq + kRows - 1) / kRows;
  swa_dkdv_kernel<T, HD><<<dim3(tiles, s.kv_heads, s.batch), kThreads,
                           dkdv_smem_bytes<HD>(), stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)g, lse, dd, (T*)dk,
      (T*)dv, s.seq, s.heads, s.kv_heads, s.hd, s.window, s.scale);
  return (int)cudaGetLastError();
}

template <class T, int HD>
int launch_jvp(const void* q, const void* k, const void* v, const void* tq,
               const void* tk, const void* tv, void* tout, const Shape& s,
               cudaStream_t stream) {
  int err = set_smem(swa_jvp_kernel<T, HD>, jvp_smem_bytes<HD>());
  if (err) return err;
  const int tiles = (s.seq + kRows - 1) / kRows;
  swa_jvp_kernel<T, HD><<<dim3(tiles, s.heads, s.batch), kThreads,
                          jvp_smem_bytes<HD>(), stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)tq, (const T*)tk,
      (const T*)tv, (T*)tout, s.seq, s.heads, s.kv_heads, s.hd, s.window,
      s.scale);
  return (int)cudaGetLastError();
}

int check(const Shape& s, int storage) {
  if (s.kv_heads <= 0 || s.heads % s.kv_heads != 0 || s.hd <= 0 ||
      s.hd > 256 || s.window < 0 || storage < 0 || storage > 1)
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

extern "C" {

const char* swa_attention_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The backward's first kernel: dq, and lse and dd, (B, H, T) f32 side
// outputs that swa_attention_dkdv_launch reads.  storage: 0 = float,
// 1 = bf16 (every tensor but lse and dd).
int swa_attention_dq_launch(const void* q, const void* k, const void* v,
                            const void* g, void* dq, void* lse, void* dd,
                            int batch, int seq, int heads, int kv_heads,
                            int hd, int window, float scale, int storage,
                            void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0) return 0;
  const Shape s{batch, seq, heads, kv_heads, hd, window, scale};
  if (int err = check(s, storage)) return err;
  cudaStream_t st = (cudaStream_t)stream;
  float* l = (float*)lse;
  float* d = (float*)dd;
  if (storage == 0) {
    if (hd <= 64) return launch_dq<float, 64>(q, k, v, g, dq, l, d, s, st);
    if (hd <= 128) return launch_dq<float, 128>(q, k, v, g, dq, l, d, s, st);
    return launch_dq<float, 256>(q, k, v, g, dq, l, d, s, st);
  }
  using B = __nv_bfloat16;
  if (hd <= 64) return launch_dq<B, 64>(q, k, v, g, dq, l, d, s, st);
  if (hd <= 128) return launch_dq<B, 128>(q, k, v, g, dq, l, d, s, st);
  return launch_dq<B, 256>(q, k, v, g, dq, l, d, s, st);
}

// The backward's second kernel: dk and dv from the dq kernel's lse and dd
// (launched after it on the same stream).
int swa_attention_dkdv_launch(const void* q, const void* k, const void* v,
                              const void* g, const void* lse, const void* dd,
                              void* dk, void* dv, int batch, int seq,
                              int heads, int kv_heads, int hd, int window,
                              float scale, int storage, void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0) return 0;
  const Shape s{batch, seq, heads, kv_heads, hd, window, scale};
  if (int err = check(s, storage)) return err;
  cudaStream_t st = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  const float* d = (const float*)dd;
  if (storage == 0) {
    if (hd <= 64) return launch_dkdv<float, 64>(q, k, v, g, l, d, dk, dv, s, st);
    if (hd <= 128) return launch_dkdv<float, 128>(q, k, v, g, l, d, dk, dv, s, st);
    return launch_dkdv<float, 256>(q, k, v, g, l, d, dk, dv, s, st);
  }
  using B = __nv_bfloat16;
  if (hd <= 64) return launch_dkdv<B, 64>(q, k, v, g, l, d, dk, dv, s, st);
  if (hd <= 128) return launch_dkdv<B, 128>(q, k, v, g, l, d, dk, dv, s, st);
  return launch_dkdv<B, 256>(q, k, v, g, l, d, dk, dv, s, st);
}

// The output's tangent for tangents (tq, tk, tv) of (q, k, v).
int swa_attention_jvp_launch(const void* q, const void* k, const void* v,
                             const void* tq, const void* tk, const void* tv,
                             void* tout, int batch, int seq, int heads,
                             int kv_heads, int hd, int window, float scale,
                             int storage, void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0) return 0;
  const Shape s{batch, seq, heads, kv_heads, hd, window, scale};
  if (int err = check(s, storage)) return err;
  cudaStream_t st = (cudaStream_t)stream;
  if (storage == 0) {
    if (hd <= 64) return launch_jvp<float, 64>(q, k, v, tq, tk, tv, tout, s, st);
    if (hd <= 128) return launch_jvp<float, 128>(q, k, v, tq, tk, tv, tout, s, st);
    return launch_jvp<float, 256>(q, k, v, tq, tk, tv, tout, s, st);
  }
  using B = __nv_bfloat16;
  if (hd <= 64) return launch_jvp<B, 64>(q, k, v, tq, tk, tv, tout, s, st);
  if (hd <= 128) return launch_jvp<B, 128>(q, k, v, tq, tk, tv, tout, s, st);
  return launch_jvp<B, 256>(q, k, v, tq, tk, tv, tout, s, st);
}

}  // extern "C"
