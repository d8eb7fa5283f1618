// Sliding-window causal attention forward for Hopper (sm_90a).
//
// q: (B, T, H, hd), k/v: (B, T, K, hd), o: (B, T, H, hd), all contiguous,
// f32 or bf16 storage.  Query t attends to the keys t - window ... t
// (window + 1 keys, clipped at 0); scores are scaled by 1/sqrt(hd), the
// softmax and P.V run in f32, the output is stored in the input type.
// Query head h reads kv head h / (H / K): MQA/GQA K/V are never repeated.
//
// Replaces the Pallas TPU kernel src/repro/kernels/swa_attention.py:79
// swa_attention (body _swa_kernel :36).
//
// What bounds it on this card: operations.  At the prefill shape of
// recurrentgemma-9b (B = 2, T = 32768, H = 16, K = 1, hd = 256, window
// 2048) the useful work is 4 B H hd sum_t (min(t, window) + 1) = 2.2
// TFLOP against 1.1 GB of q, k, v and o.  This first kernel does that
// work in f32 on the CUDA cores (67 TFLOP/s), not on the tensor cores;
// making it fast (wgmma, TMA, bf16 QK^T) is later work.  The design:
//   * one block per (64-query tile, head, batch row); 256 threads as a
//     16 x 16 grid, each owning 4 queries x 4 keys of a score tile and 4
//     queries x hd/16 dims of the output accumulator, in registers;
//   * a loop over the 64-key tiles that meet [q0 - window, q_last] takes
//     the place of the TPU's sequential window grid axis; tiles wholly
//     outside the window are never visited;
//   * Q (transposed), K (transposed) and V tiles and the probability
//     tile are staged in shared memory as f32 (222 KB at hd = 256, so
//     dynamic shared memory above 48 KB); head dims are zero-padded to
//     64, 128 or 256 and rows past T are zero-filled, so any T, hd <= 256
//     and window are taken, the ragged edge masked here;
//   * online softmax with m, l and acc in f32.  A masked score gets
//     probability 0 explicitly, so a row whose tiles so far were all
//     masked holds l = 0 and acc = 0 (the Pallas kernel's NEG sentinel
//     would give exp(NEG - NEG) = 1 there and relies on a later rescale);
//   * no atomics: sums run in a fixed order, so two launches on the same
//     inputs give the same bits.
//
// The kernel allocates nothing and launches on the stream it is given.
// Plain C interface (ctypes); the launcher returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;                // queries per block
constexpr int kBKV = 64;               // keys per tile
constexpr int kThreads = 256;          // 16 x 16
constexpr int kLd = kBQ + 4;           // row stride of the transposed tiles
constexpr float kNeg = -1e30f;
static_assert(kBQ == kBKV, "the transposed tiles share one row stride");

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

// Qt[HD][kLd], Kt[HD][kLd], Vs[kBKV][HD], Pt[kBKV][kLd], all f32
template <int HD>
constexpr int smem_bytes() {
  return (int)sizeof(float) * (2 * HD * kLd + kBKV * HD + kBKV * kLd);
}

template <class T, int HD>
__global__ void __launch_bounds__(kThreads)
swa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ o, int seq,
               int heads, int kv_heads, int hd, int window, float scale) {
  constexpr int kDims = HD / 16;       // output dims per thread
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;
  float* Kt = Qt + HD * kLd;
  float* Vs = Kt + HD * kLd;
  float* Pt = Vs + kBKV * HD;

  const int tid = threadIdx.x;
  const int tx = tid & 15;             // key / dim group
  const int ty = tid >> 4;             // query group
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (heads / kv_heads);
  const long long q_row = (long long)heads * hd;
  const long long kv_row = (long long)kv_heads * hd;
  const T* qb = q + (long long)b * seq * q_row + (long long)h * hd;
  const T* kb = k + (long long)b * seq * kv_row + (long long)kvh * hd;
  const T* vb = v + (long long)b * seq * kv_row + (long long)kvh * hd;
  T* ob = o + (long long)b * seq * q_row + (long long)h * hd;

  // Q tile, transposed: Qt[d][r] = q[q0 + r][d]; coalesced reads along d
  for (int idx = tid; idx < kBQ * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    const int t = q0 + r;
    Qt[d * kLd + r] =
        (t < seq && d < hd) ? to_f32(qb[(long long)t * q_row + d]) : 0.f;
  }

  float acc[4][kDims];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < kDims; ++e) acc[i][e] = 0.f;
  }

  const int q_last = min(q0 + kBQ, seq) - 1;
  const int k_begin = max(0, q0 - window);
  for (int k0 = k_begin; k0 <= q_last; k0 += kBKV) {
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < kBKV * HD; idx += kThreads) {
      const int r = idx / HD, d = idx % HD;
      const int t = k0 + r;
      float kx = 0.f, vx = 0.f;
      if (t < seq && d < hd) {
        kx = to_f32(kb[(long long)t * kv_row + d]);
        vx = to_f32(vb[(long long)t * kv_row + d]);
      }
      Kt[d * kLd + r] = kx;
      Vs[r * HD + d] = vx;
    }
    __syncthreads();

    // scores of queries ty*4 + i against keys tx*4 + j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(&Qt[d * kLd + ty * 4]);
      const float4 kv = *reinterpret_cast<const float4*>(&Kt[d * kLd + tx * 4]);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      const float ka[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
    }

    // mask, online softmax; a row's 16 key groups are 16 lanes of a warp
    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      bool valid[4];
      float mt = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx * 4 + j;
        valid[j] = qpos < seq && kpos < seq && kpos <= qpos &&
                   kpos >= qpos - window;
        s[i][j] = valid[j] ? s[i][j] * scale : kNeg;
        mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      float ls = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = valid[j] ? expf(s[i][j] - m_new) : 0.f;
        ls += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        ls += __shfl_xor_sync(0xffffffffu, ls, off);
      corr[i] = expf(m[i] - m_new);    // 1 while the row saw no valid key
      l[i] = l[i] * corr[i] + ls;
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&Pt[(tx * 4 + j) * kLd + ty * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < kDims; ++e) acc[i][e] *= corr[i];
    __syncthreads();

    // acc += P V over the tile's keys; thread dims g*64 + tx*4 + c
#pragma unroll 4
    for (int j = 0; j < kBKV; ++j) {
      const float4 pv = *reinterpret_cast<const float4*>(&Pt[j * kLd + ty * 4]);
      const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int g = 0; g < HD / 64; ++g) {
        const float4 vv =
            *reinterpret_cast<const float4*>(&Vs[j * HD + g * 64 + tx * 4]);
        const float va[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[i][g * 4 + c] = fmaf(pa[i], va[c], acc[i][g * 4 + c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    if (qpos >= seq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int g = 0; g < HD / 64; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int d = g * 64 + tx * 4 + c;
        if (d < hd)
          ob[(long long)qpos * q_row + d] = from_f32<T>(acc[i][g * 4 + c] / denom);
      }
  }
}

template <class T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int seq, int heads, int kv_heads, int hd, int window, float scale,
           cudaStream_t stream) {
  constexpr int smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      swa_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((seq + kBQ - 1) / kBQ, heads, batch);
  swa_fwd_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, seq, heads, kv_heads, hd,
      window, scale);
  return (int)cudaGetLastError();
}

template <class T>
int launch_hd(const void* q, const void* k, const void* v, void* o,
              int batch, int seq, int heads, int kv_heads, int hd,
              int window, float scale, cudaStream_t stream) {
  if (hd <= 64)
    return launch<T, 64>(q, k, v, o, batch, seq, heads, kv_heads, hd, window,
                         scale, stream);
  if (hd <= 128)
    return launch<T, 128>(q, k, v, o, batch, seq, heads, kv_heads, hd,
                          window, scale, stream);
  return launch<T, 256>(q, k, v, o, batch, seq, heads, kv_heads, hd, window,
                        scale, stream);
}

}  // namespace

extern "C" {

const char* swa_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// storage: 0 = float, 1 = bf16 (q, k, v and o all of it)
int swa_attention_launch(const void* q, const void* k, const void* v, void* o,
                         int batch, int seq, int heads, int kv_heads, int hd,
                         int window, float scale, int storage, void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0) return 0;
  if (kv_heads <= 0 || heads % kv_heads != 0 || hd <= 0 || hd > 256 ||
      window < 0)
    return (int)cudaErrorInvalidValue;
  if (storage == 0)
    return launch_hd<float>(q, k, v, o, batch, seq, heads, kv_heads, hd,
                            window, scale, (cudaStream_t)stream);
  if (storage == 1)
    return launch_hd<__nv_bfloat16>(q, k, v, o, batch, seq, heads, kv_heads,
                                    hd, window, scale, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
