// General-DAG lattice kernels for Hopper (sm_90a): forward, backward and
// the fused loss-only forward over level-major frontier tensors.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/lattice_fb.py:
//   dag_forward_kernel   <- dag_forward   (:419, body _dag_fwd_kernel :331)
//   dag_backward_kernel  <- dag_backward  (:465, body _dag_bwd_kernel :375)
//   dag_loss_only_kernel <- dag_loss_only (:563, body _dag_loss_only_kernel
//                                          :499; its host prologue stays in
//                                          the PyTorch wrapper, as in JAX)
//
// What bounds them on this card: the chain of L dependent levels, not
// bytes and not arithmetic.  Level l reads what level l-1 wrote, so a
// level costs at least one round trip to L2 for the predecessor gather
// plus a block barrier, whatever the width; the bytes each kernel must
// move are a few MB at the service's shapes (microseconds at 3.35 TB/s).
// The design keeps that chain as short as the data allows and nothing
// else in it:
//   * one thread block per utterance (grid = B); blocks never exchange
//     data, so a request's result does not depend on its batch mates;
//   * threads stride over the W slots of a level, each reducing its
//     slot's P predecessors (S successors) sequentially with exactly the
//     semantics of _masked_lse_rows: valid = x > NEG/2, pivot 0 for an
//     all-masked row, lse = NEG and all-zero weights for such a row,
//     max(z, EPS) guards;
//   * __syncthreads() between levels takes the place of the TPU's
//     in-order grid;
//   * the (L*W+1) alpha/beta buffers live in global memory (scratch the
//     wrapper allocates, dump slot at L*W), not in shared memory: a
//     streaming session bucket has W = A, e.g. 250 levels x 900 slots =
//     1.8 MB per utterance for alpha + c_alpha, far over the 227 KB a
//     block may hold.  They stay hot in the 50 MB L2.
//   * deterministic: no atomics; the final-arc reduction over the L*W
//     slots is folded by one warp in flat level-major order (ballot over
//     32 slots, then the final lanes in ascending order), so it depends
//     only on the sequence of final slots.  Masked slots add exact zeros.
//   * an out-of-range position in pidx/sidx reads the dump slot, an
//     out-of-range arc id in level_arcs is an empty slot, and a gather
//     position into the cumsum grid is clamped: no input can fault.
//
// The kernels allocate nothing and launch on the stream they are given.
// Plain C interface (ctypes); each launcher returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr float kHalfNeg = -5e29f;   // NEG * 0.5: the validity threshold
constexpr float kEps = 1e-30f;

__device__ __forceinline__ bool is_set(float f) { return f > 0.5f; }

// position into the flat (LW+1) buffer; out-of-range -> dump slot LW
__device__ __forceinline__ long long buf_pos(int p, long long LW) {
  return (p >= 0 && (long long)p < LW) ? (long long)p : LW;
}

// gather position into a cumsum-grid row of G entries, clamped
__device__ __forceinline__ long long grid_pos(int p, long long G) {
  return p < 0 ? 0LL : ((long long)p < G ? (long long)p : G - 1);
}

// Sequential masked logsumexp + masked-softmax-weighted sum over one row
// of n entries.  Row::x(j) is entry j's log value, Row::c(j) its linear
// value.  Returns lse (NEG for an all-masked row) and sum_j w_j * c_j.
template <class Row>
__device__ __forceinline__ void masked_lse_row(const Row& row, int n,
                                               float& lse, float& cw) {
  bool has = false;
  float m = kNeg;
  for (int j = 0; j < n; ++j) {
    const float x = row.x(j);
    if (x > kHalfNeg) {
      has = true;
      m = fmaxf(m, x);
    }
  }
  const float m0 = has ? m : 0.f;
  float z = 0.f;
  for (int j = 0; j < n; ++j) {
    const float x = row.x(j);
    if (x > kHalfNeg) z += expf(x - m0);
  }
  const float zc = fmaxf(z, kEps);
  lse = has ? fmaxf(logf(zc) + m0, kNeg) : kNeg;
  float c = 0.f;
  for (int j = 0; j < n; ++j) {
    const float x = row.x(j);
    if (x > kHalfNeg) c += (expf(x - m0) / zc) * row.c(j);
  }
  cw = c;
}

// forward row: predecessors' alpha / c_alpha
struct FwdRow {
  const float* abuf;
  const float* cbuf;
  const int* pos;
  long long LW;
  __device__ float x(int j) const { return abuf[buf_pos(pos[j], LW)]; }
  __device__ float c(int j) const { return cbuf[buf_pos(pos[j], LW)]; }
};

// backward row: successors' beta + own score / c_beta + corr (masked
// successors score NEG, the dump slot contributes NEG / 0)
struct BwdRow {
  const float* bbuf;
  const float* cbbuf;
  const float* own;
  const float* corr;
  const float* ok;
  const int* pos;
  long long LW;
  __device__ float x(int j) const {
    const long long p = buf_pos(pos[j], LW);
    if (p == LW) return kNeg;
    return bbuf[p] + (is_set(ok[p]) ? own[p] : kNeg);
  }
  __device__ float c(int j) const {
    const long long p = buf_pos(pos[j], LW);
    if (p == LW) return 0.f;
    return cbbuf[p] + (is_set(ok[p]) ? corr[p] : 0.f);
  }
};

__device__ __forceinline__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31;
  if (lane == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = (lane < (int)(blockDim.x >> 5)) ? red[lane] : kNeg;
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();
  return v;
}

__device__ void init_buffers(float* lbuf, float* cbuf, long long LW) {
  for (long long i = threadIdx.x; i <= LW; i += blockDim.x) {
    lbuf[i] = kNeg;
    cbuf[i] = 0.f;
  }
  __syncthreads();
}

// The level-by-level forward recursion of one utterance into abuf/cbuf
// (level-major, dump slot at LW, already initialised to NEG / 0).
__device__ void forward_levels(const float* own, const float* corr,
                               const float* start, const float* ok,
                               const int* pidx, float* abuf, float* cbuf,
                               int L, int W, int P) {
  const long long LW = (long long)L * W;
  for (int l = 0; l < L; ++l) {
    for (int w = threadIdx.x; w < W; w += blockDim.x) {
      const long long s = (long long)l * W + w;
      float a_val = kNeg, c_val = 0.f;
      if (is_set(ok[s])) {
        if (is_set(start[s])) {
          a_val = own[s];
          c_val = corr[s] + 0.f;
        } else {
          float in_log, c_in;
          masked_lse_row(FwdRow{abuf, cbuf, pidx + s * P, LW}, P, in_log,
                         c_in);
          a_val = own[s] + in_log;
          c_val = corr[s] + c_in;
        }
      }
      abuf[s] = a_val;
      cbuf[s] = c_val;
    }
    __syncthreads();
  }
}

// logZ / c_avg over the final slots: order-free exact max over the
// block, then warp 0 folds exp-sums and weighted correctness in flat
// level-major order.
__device__ void final_reduce(const float* fin, const float* abuf,
                             const float* cbuf, long long LW,
                             float* logz_out, float* cavg_out) {
  __shared__ float red[32];
  float m = kNeg;
  for (long long s = threadIdx.x; s < LW; s += blockDim.x) {
    if (is_set(fin[s])) {
      const float x = abuf[s];
      if (x > kHalfNeg) m = fmaxf(m, x);
    }
  }
  m = block_max(m, red);
  if (threadIdx.x >= 32) return;
  const bool has = m > kHalfNeg;
  const float m0 = has ? m : 0.f;
  const int lane = threadIdx.x;
  float z = 0.f;
  for (long long base = 0; base < LW; base += 32) {
    const long long s = base + lane;
    float e = 0.f;
    bool v = false;
    if (s < LW && is_set(fin[s])) {
      const float x = abuf[s];
      if (x > kHalfNeg) {
        v = true;
        e = expf(x - m0);
      }
    }
    unsigned mask = __ballot_sync(0xffffffffu, v);
    while (mask) {
      const int j = __ffs(mask) - 1;
      z += __shfl_sync(0xffffffffu, e, j);
      mask &= mask - 1;
    }
  }
  const float zc = fmaxf(z, kEps);
  float c = 0.f;
  for (long long base = 0; base < LW; base += 32) {
    const long long s = base + lane;
    float t = 0.f;
    bool v = false;
    if (s < LW && is_set(fin[s])) {
      const float x = abuf[s];
      if (x > kHalfNeg) {
        v = true;
        t = (expf(x - m0) / zc) * cbuf[s];
      }
    }
    unsigned mask = __ballot_sync(0xffffffffu, v);
    while (mask) {
      const int j = __ffs(mask) - 1;
      c += __shfl_sync(0xffffffffu, t, j);
      mask &= mask - 1;
    }
  }
  if (lane == 0) {
    *logz_out = has ? fmaxf(logf(zc) + m0, kNeg) : kNeg;
    *cavg_out = c;
  }
}

__global__ void dag_forward_kernel(const float* own, const float* corr,
                                   const float* start, const float* ok,
                                   const float* fin, const int* pidx,
                                   float* abuf, float* cbuf, float* logz,
                                   float* cavg, int L, int W, int P) {
  const long long LW = (long long)L * W;
  const long long b = blockIdx.x;
  const long long o = b * LW;
  float* ab = abuf + b * (LW + 1);
  float* cb = cbuf + b * (LW + 1);
  init_buffers(ab, cb, LW);
  forward_levels(own + o, corr + o, start + o, ok + o, pidx + o * P, ab, cb,
                 L, W, P);
  final_reduce(fin + o, ab, cb, LW, logz + b, cavg + b);
}

__global__ void dag_backward_kernel(const float* own, const float* corr,
                                    const float* fin, const float* ok,
                                    const int* sidx, float* bbuf,
                                    float* cbbuf, int L, int W, int S) {
  const long long LW = (long long)L * W;
  const long long b = blockIdx.x;
  const long long o = b * LW;
  own += o;
  corr += o;
  fin += o;
  ok += o;
  sidx += o * S;
  float* bb = bbuf + b * (LW + 1);
  float* cb = cbbuf + b * (LW + 1);
  init_buffers(bb, cb, LW);
  for (int l = L - 1; l >= 0; --l) {
    for (int w = threadIdx.x; w < W; w += blockDim.x) {
      const long long s = (long long)l * W + w;
      float b_val = kNeg, c_val = 0.f;
      if (is_set(ok[s])) {
        if (is_set(fin[s])) {
          b_val = 0.f;
          c_val = 0.f;
        } else {
          masked_lse_row(BwdRow{bb, cb, own, corr, ok, sidx + s * S, LW}, S,
                         b_val, c_val);
        }
      }
      bb[s] = b_val;
      cb[s] = c_val;
    }
    __syncthreads();
  }
}

// Fused loss-only forward.  cum: (B, G) kappa-scaled centred cumsum grid
// with the mean row appended; idx: (B, 3A) [end|start|mean] positions into
// it; fcs: (B, 6, A) [span, lm, corr, arc_mask, is_start, is_final];
// level_arcs: (B, L, W); pidx: (B, L, W, P).  Scratch: lv (B, 5, LW)
// level-major [own, corr, ok, start, final], abuf/cbuf (B, LW+1).
__global__ void dag_loss_only_kernel(const float* cum, long long G,
                                     const int* idx, const float* fcs,
                                     const int* level_arcs, const int* pidx,
                                     float* lv, float* abuf, float* cbuf,
                                     float* logz, float* cavg, int A, int L,
                                     int W, int P) {
  const long long LW = (long long)L * W;
  const long long b = blockIdx.x;
  cum += b * G;
  idx += b * 3LL * A;
  fcs += b * 6LL * A;
  level_arcs += b * LW;
  pidx += b * LW * P;
  float* own = lv + b * 5LL * LW;
  float* corr = own + LW;
  float* okf = corr + LW;
  float* st = okf + LW;
  float* fn = st + LW;
  float* ab = abuf + b * (LW + 1);
  float* cb = cbuf + b * (LW + 1);
  init_buffers(ab, cb, LW);
  // endpoint gather (3 grid reads per arc) fused with the arc ->
  // level-major gather: each arc sits in at most one slot
  for (long long s = threadIdx.x; s < LW; s += blockDim.x) {
    const int a = level_arcs[s];
    if (a < 0 || a >= A) {
      own[s] = kNeg;
      corr[s] = 0.f;
      okf[s] = 0.f;
      st[s] = 0.f;
      fn[s] = 0.f;
      continue;
    }
    const long long ie = grid_pos(idx[a], G);
    const long long is = grid_pos(idx[A + a], G);
    const long long im = grid_pos(idx[2LL * A + a], G);
    own[s] = (cum[ie] - cum[is] + fcs[a] * cum[im]) + fcs[A + a];
    corr[s] = fcs[2LL * A + a];
    const bool o = is_set(fcs[3LL * A + a]);
    okf[s] = o ? 1.f : 0.f;
    st[s] = (o && is_set(fcs[4LL * A + a])) ? 1.f : 0.f;
    fn[s] = (o && is_set(fcs[5LL * A + a])) ? 1.f : 0.f;
  }
  __syncthreads();
  forward_levels(own, corr, st, okf, pidx, ab, cb, L, W, P);
  final_reduce(fn, ab, cb, LW, logz + b, cavg + b);
}

}  // namespace

extern "C" {

const char* lattice_dag_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int dag_forward_launch(const float* own, const float* corr,
                       const float* start, const float* ok, const float* fin,
                       const int* pidx, float* abuf, float* cbuf, float* logz,
                       float* cavg, int B, int L, int W, int P, int threads,
                       void* stream) {
  dag_forward_kernel<<<B, threads, 0, (cudaStream_t)stream>>>(
      own, corr, start, ok, fin, pidx, abuf, cbuf, logz, cavg, L, W, P);
  return (int)cudaGetLastError();
}

int dag_backward_launch(const float* own, const float* corr, const float* fin,
                        const float* ok, const int* sidx, float* bbuf,
                        float* cbbuf, int B, int L, int W, int S, int threads,
                        void* stream) {
  dag_backward_kernel<<<B, threads, 0, (cudaStream_t)stream>>>(
      own, corr, fin, ok, sidx, bbuf, cbbuf, L, W, S);
  return (int)cudaGetLastError();
}

int dag_loss_only_launch(const float* cum, long long G, const int* idx,
                         const float* fcs, const int* level_arcs,
                         const int* pidx, float* lv, float* abuf, float* cbuf,
                         float* logz, float* cavg, int B, int A, int L, int W,
                         int P, int threads, void* stream) {
  dag_loss_only_kernel<<<B, threads, 0, (cudaStream_t)stream>>>(
      cum, G, idx, fcs, level_arcs, pidx, lv, abuf, cbuf, logz, cavg, A, L,
      W, P);
  return (int)cudaGetLastError();
}

}  // extern "C"
