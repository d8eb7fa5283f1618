// Sausage (confusion-network) lattice kernels for Hopper (sm_90a):
// forward, backward and the fused loss-only forward over (B, S, A)
// segment/alternative tiles.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/lattice_fb.py:
//   sausage_forward_kernel   <- sausage_forward   (:154, body _fwd_kernel :89)
//   sausage_backward_kernel  <- sausage_backward  (:610, body _bwd_kernel :119)
//   sausage_loss_only_kernel <- sausage_loss_only (:249, body
//                               _loss_only_kernel :189; its host prologue,
//                               the kappa-scaled centred cumsum grid, stays
//                               in the PyTorch wrapper, as in JAX)
//
// What bounds them on this card: the chain of S dependent segments, not
// bytes and not arithmetic.  Segment s needs the carry (in_log, c_in) of
// segment s-1, and each step is a max, an exp-sum and a weighted sum over
// only A (typically 3) alternatives.  At the training shape (B=32, S=50,
// A=3) the forward kernel moves about 96 KB, a few hundredths of a
// microsecond at 3.35 TB/s, so the kernels are latency-bound on the S
// dependent steps.  The design keeps each step inside one warp:
//   * one warp per utterance, four utterances per block; warps never
//     exchange data, so an utterance's result does not depend on its
//     batch mates;
//   * the A alternatives of a segment sit on the lanes (chunks of 32 when
//     A > 32); the carry lives in registers, replicated on every lane;
//   * max and sums over the row by warp shuffle (xor butterfly: a fixed
//     combination order, so results are deterministic); no shared memory
//     and no __syncthreads per segment;
//   * the mask is honoured exactly as the TPU kernel does: valid = m > 0.5,
//     the exp weight is multiplied by m, a segment with no valid arc
//     passes the carry through, and z is clamped to EPS;
//   * an out-of-range arc id in level_arcs is a masked slot and a gather
//     position into the cumsum grid is clamped: no input can fault.
//
// The kernels allocate nothing and launch on the stream they are given.
// Plain C interface (ctypes); each launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr float kEps = 1e-30f;
constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ bool warp_any(bool v) {
  return __any_sync(kFull, v) != 0;
}

// One segment of the recursion over a row of A alternatives held by the
// warp.  Row::load(a, score, corr, m) fetches alternative a; the row value
// is score + carry_log on valid arcs and NEG elsewhere, its correctness
// value corr + carry_corr (0 elsewhere).  Sink::put(a, row, c_row) sees
// every alternative's row values (the forward kernel writes them).
// Updates (carry_log, carry_c) as the TPU kernel does.  The weighted sum
// is over wsum(a) = c_row (forward) or corr + c_carry_out (backward),
// which callers express through Row::weight_value.
template <class Row, class Sink>
__device__ __forceinline__ void segment_step(const Row& row, int A,
                                             float& carry_log,
                                             float& carry_c, Sink& sink) {
  const int lane = threadIdx.x & 31;
  // pass 1: row values, their max, and whether any arc is valid
  float mx = -INFINITY;
  bool any_valid = false;
  for (int base = 0; base < A; base += 32) {
    const int a = base + lane;
    if (a < A) {
      float sc, co, m;
      row.load(a, sc, co, m);
      const bool valid = m > 0.5f;
      const float r = valid ? sc + carry_log : kNeg;
      sink.put(a, r, valid ? co + carry_c : 0.f);
      mx = fmaxf(mx, r);
      any_valid |= valid;
    }
  }
  mx = warp_max(mx);
  const bool seg_valid = warp_any(any_valid);
  // pass 2: z = sum exp(row - mx) * m
  float z = 0.f;
  for (int base = 0; base < A; base += 32) {
    const int a = base + lane;
    if (a < A) {
      float sc, co, m;
      row.load(a, sc, co, m);
      const float r = m > 0.5f ? sc + carry_log : kNeg;
      z += expf(r - mx) * m;
    }
  }
  z = warp_sum(z);
  const float zc = fmaxf(z, kEps);
  // pass 3: sum of softmax weights times the correctness values
  float c = 0.f;
  for (int base = 0; base < A; base += 32) {
    const int a = base + lane;
    if (a < A) {
      float sc, co, m;
      row.load(a, sc, co, m);
      const bool valid = m > 0.5f;
      const float r = valid ? sc + carry_log : kNeg;
      const float w = (expf(r - mx) * m) / zc;
      c += w * row.weight_value(valid, co, carry_c);
    }
  }
  c = warp_sum(c);
  if (seg_valid) {
    carry_log = logf(zc) + mx;
    carry_c = c;
  }
}

// A (S, A) tile row in memory (forward and backward kernels).
struct TileRow {
  const float* score;
  const float* corr;
  const float* mask;
  bool backward;
  __device__ void load(int a, float& sc, float& co, float& m) const {
    sc = score[a];
    co = corr[a];
    m = mask[a];
  }
  // forward: w * c_row, c_row = corr + c_in on valid arcs;
  // backward: w * (corr + cb_row), cb_row = c_out on valid arcs
  __device__ float weight_value(bool valid, float co, float carry_c) const {
    return backward ? co + (valid ? carry_c : 0.f)
                    : (valid ? co + carry_c : 0.f);
  }
};

struct WriteRow {
  float* a;
  float* c;
  __device__ void put(int i, float r, float cr) {
    a[i] = r;
    c[i] = cr;
  }
};

struct NoWrite {
  __device__ void put(int, float, float) {}
};

// An (S, W) row gathered from arc layout through level_arcs, with the
// arc scores built from the kappa-scaled centred cumsum grid.
struct GridRow {
  const float* cum;  // (G,) one utterance's grid row
  long long G;
  const int* idx;    // (3A,) [end | start | mean] positions into cum
  const float* fcs;  // (6, A) [span, lm, corr, arc_mask, is_start, is_final]
  const int* la;     // (W,) this segment's slots
  int A;
  __device__ long long pos(int p) const {
    return p < 0 ? 0LL : ((long long)p < G ? (long long)p : G - 1);
  }
  __device__ void load(int w, float& sc, float& co, float& m) const {
    const int a = la[w];
    if (a < 0 || a >= A) {
      sc = 0.f;
      co = 0.f;
      m = 0.f;
      return;
    }
    sc = (cum[pos(idx[a])] - cum[pos(idx[A + a])] +
          fcs[a] * cum[pos(idx[2 * A + a])]) + fcs[A + a];
    co = fcs[2 * A + a];
    m = fcs[3 * A + a];
  }
  __device__ float weight_value(bool valid, float co, float carry_c) const {
    return valid ? co + carry_c : 0.f;
  }
};

__global__ void sausage_forward_kernel(const float* score, const float* corr,
                                       const float* mask, float* alpha,
                                       float* c_alpha, float* logz,
                                       float* cavg, int B, int S, int A) {
  const int b = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= B) return;  // whole warp leaves together
  const long long o = (long long)b * S * A;
  float in_log = 0.f, c_in = 0.f;
  for (int s = 0; s < S; ++s) {
    const long long r = o + (long long)s * A;
    TileRow row{score + r, corr + r, mask + r, false};
    WriteRow sink{alpha + r, c_alpha + r};
    segment_step(row, A, in_log, c_in, sink);
  }
  if ((threadIdx.x & 31) == 0) {
    logz[b] = in_log;
    cavg[b] = c_in;
  }
}

__global__ void sausage_backward_kernel(const float* score, const float* corr,
                                        const float* mask, float* beta,
                                        float* c_beta, int B, int S, int A) {
  const int b = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= B) return;
  const int lane = threadIdx.x & 31;
  const long long o = (long long)b * S * A;
  float out_log = 0.f, c_out = 0.f;
  for (int s = S - 1; s >= 0; --s) {
    const long long r = o + (long long)s * A;
    // beta / c_beta of this segment are the carry from the segment after
    for (int base = 0; base < A; base += 32) {
      const int a = base + lane;
      if (a < A) {
        const bool valid = mask[r + a] > 0.5f;
        beta[r + a] = valid ? out_log : kNeg;
        c_beta[r + a] = valid ? c_out : 0.f;
      }
    }
    TileRow row{score + r, corr + r, mask + r, true};
    NoWrite sink;
    segment_step(row, A, out_log, c_out, sink);
  }
}

__global__ void sausage_loss_only_kernel(const float* cum, long long G,
                                         const int* idx, const float* fcs,
                                         const int* level_arcs, float* logz,
                                         float* cavg, int B, int A, int S,
                                         int W) {
  const int b = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= B) return;
  const long long sw = (long long)S * W;
  float in_log = 0.f, c_in = 0.f;
  for (int s = 0; s < S; ++s) {
    GridRow row{cum + (long long)b * G, G, idx + (long long)b * 3 * A,
                fcs + (long long)b * 6 * A, level_arcs + b * sw + (long long)s * W,
                A};
    NoWrite sink;
    segment_step(row, W, in_log, c_in, sink);
  }
  if ((threadIdx.x & 31) == 0) {
    logz[b] = in_log;
    cavg[b] = c_in;
  }
}

int blocks_for(int B) { return (B + kWarpsPerBlock - 1) / kWarpsPerBlock; }

}  // namespace

extern "C" {

const char* lattice_sausage_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int sausage_forward_launch(const float* score, const float* corr,
                           const float* mask, float* alpha, float* c_alpha,
                           float* logz, float* cavg, int B, int S, int A,
                           void* stream) {
  sausage_forward_kernel<<<blocks_for(B), 32 * kWarpsPerBlock, 0,
                           (cudaStream_t)stream>>>(
      score, corr, mask, alpha, c_alpha, logz, cavg, B, S, A);
  return (int)cudaGetLastError();
}

int sausage_backward_launch(const float* score, const float* corr,
                            const float* mask, float* beta, float* c_beta,
                            int B, int S, int A, void* stream) {
  sausage_backward_kernel<<<blocks_for(B), 32 * kWarpsPerBlock, 0,
                            (cudaStream_t)stream>>>(score, corr, mask, beta,
                                                    c_beta, B, S, A);
  return (int)cudaGetLastError();
}

int sausage_loss_only_launch(const float* cum, long long G, const int* idx,
                             const float* fcs, const int* level_arcs,
                             float* logz, float* cavg, int B, int A, int S,
                             int W, void* stream) {
  sausage_loss_only_kernel<<<blocks_for(B), 32 * kWarpsPerBlock, 0,
                             (cudaStream_t)stream>>>(cum, G, idx, fcs,
                                                     level_arcs, logz, cavg,
                                                     B, A, S, W);
  return (int)cudaGetLastError();
}

}  // extern "C"
