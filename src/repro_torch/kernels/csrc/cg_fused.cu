// Fused CG vector update for Hopper (sm_90a): one pass over flat (N,)
// buffers computes
//     x <- x + alpha v,   r <- r - alpha Bv,   rr = <r, r>
// with the arithmetic in f32 and x, r stored in the storage type (float
// or bf16, the CG state dtype).
//
// Replaces the Pallas TPU kernel src/repro/kernels/cg_fused.py:43
// cg_fused_update (body _cg_kernel :29).
//
// What bounds it on this card: bytes.  It reads x, v, r, Bv once and
// writes x, r once: 6 N elements, 464 MB for the full-width LSTM's
// N = 19,335,000 f32 parameters, 0.139 ms at 3.35 TB/s; it does 6 flops
// per element.  The design streams each element once, coalesced:
//   * tiles of 65536 elements (the TPU kernel's block), one thread block
//     per tile; the ragged last tile is masked here, so the wrapper pads
//     nothing (the JAX wrapper's jnp.pad copies four theta-sized arrays);
//   * alpha is read from device memory, so the host never waits for it;
//   * each block reduces its tile's sum of r_new^2 (f32, before the
//     store) in a fixed-order shared-memory tree into a partial; a second
//     one-block launch folds the partials in double, each thread a
//     strided slice and then a fixed-order tree.  An f32 fold in index
//     order drifted 1.1e-6 from the plain sum at N = 130,737,152 (1995
//     partials); in double the fold adds no error of its own.  No
//     atomics: two launches on the same inputs give the same bits.
//
// The kernels allocate nothing (the wrapper passes the partials buffer)
// and launch on the stream they are given.  Plain C interface (ctypes);
// the launcher returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr long long kTile = 65536;
constexpr int kThreads = 1024;

template <class T>
__device__ __forceinline__ float load_f32(const T* p, long long i);
template <>
__device__ __forceinline__ float load_f32<float>(const float* p,
                                                 long long i) {
  return p[i];
}
template <>
__device__ __forceinline__ float load_f32<__nv_bfloat16>(
    const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}

template <class T>
__device__ __forceinline__ void store_f32(T* p, long long i, float v);
template <>
__device__ __forceinline__ void store_f32<float>(float* p, long long i,
                                                 float v) {
  p[i] = v;
}
template <>
__device__ __forceinline__ void store_f32<__nv_bfloat16>(__nv_bfloat16* p,
                                                         long long i,
                                                         float v) {
  p[i] = __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

template <class T>
__global__ void __launch_bounds__(kThreads)
cg_update_kernel(const float* alpha_p, const T* x, const T* v, const T* r,
                 const T* bv, T* x_out, T* r_out, float* partial,
                 long long n) {
  __shared__ float red[kThreads];
  const float alpha = *alpha_p;
  const long long lo = (long long)blockIdx.x * kTile;
  const long long hi = lo + kTile < n ? lo + kTile : n;
  float acc = 0.f;
#pragma unroll 4
  for (long long i = lo + threadIdx.x; i < hi; i += kThreads) {
    const float xn = load_f32(x, i) + alpha * load_f32(v, i);
    const float rn = load_f32(r, i) - alpha * load_f32(bv, i);
    store_f32(x_out, i, xn);
    store_f32(r_out, i, rn);
    acc += rn * rn;
  }
  red[threadIdx.x] = acc;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if ((int)threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) partial[blockIdx.x] = red[0];
}

// one block folds the per-tile partials in double: thread t sums tiles
// t, t + kFold, ... in order, then a fixed-order shared-memory tree
constexpr int kFold = 1024;

__global__ void __launch_bounds__(kFold)
sum_partials_kernel(const float* partial, int n_tiles, float* rr) {
  __shared__ double red[kFold];
  double s = 0.0;
  for (int i = threadIdx.x; i < n_tiles; i += kFold) s += (double)partial[i];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int k = kFold / 2; k > 0; k >>= 1) {
    if ((int)threadIdx.x < k) red[threadIdx.x] += red[threadIdx.x + k];
    __syncthreads();
  }
  if (threadIdx.x == 0) *rr = (float)red[0];
}

template <class T>
int launch(const float* alpha, const void* x, const void* v, const void* r,
           const void* bv, void* x_out, void* r_out, float* partial,
           float* rr, long long n, cudaStream_t stream) {
  const int tiles = (int)((n + kTile - 1) / kTile);
  if (tiles > 0) {
    cg_update_kernel<T><<<tiles, kThreads, 0, stream>>>(
        alpha, (const T*)x, (const T*)v, (const T*)r, (const T*)bv,
        (T*)x_out, (T*)r_out, partial, n);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  sum_partials_kernel<<<1, kFold, 0, stream>>>(partial, tiles, rr);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* cg_fused_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// storage: 0 = float, 1 = bf16 (x, v, r, bv, x_out, r_out all of it)
int cg_fused_update_launch(const float* alpha, const void* x, const void* v,
                           const void* r, const void* bv, void* x_out,
                           void* r_out, float* partial, float* rr,
                           long long n, int storage, void* stream) {
  if (storage == 0)
    return launch<float>(alpha, x, v, r, bv, x_out, r_out, partial, rr, n,
                         (cudaStream_t)stream);
  if (storage == 1)
    return launch<__nv_bfloat16>(alpha, x, v, r, bv, x_out, r_out, partial,
                                 rr, n, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
