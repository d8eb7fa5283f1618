// Sausage (confusion-network) lattice kernels for Hopper (sm_90a):
// forward, backward and the fused loss-only forward over (B, S, A)
// segment/alternative tiles.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/lattice_fb.py:
//   sausage_forward_kernel   <- sausage_forward   (:154, body _fwd_kernel :89)
//   sausage_backward_kernel  <- sausage_backward  (:610, body _bwd_kernel :119)
//   sausage_loss_only_kernel <- sausage_loss_only (:249, body
//                               _loss_only_kernel :189, and the host
//                               prologue that builds its cumsum grid)
//
// What bounds them on this card: the chain of S dependent segments, not
// bytes and not arithmetic.  Segment s needs the carry (in_log, c_in) of
// segment s-1, and each step is a max, an exp-sum and a weighted sum over
// only A (typically 3) alternatives.  At the training shape (B=32, S=50,
// A=3) the forward kernel moves about 96 KB, a few hundredths of a
// microsecond at 3.35 TB/s, so the kernels are latency-bound on the S
// dependent steps.  The design keeps each step inside one warp:
//   * one warp per utterance, four utterances per block (the forward and
//     backward kernels; the loss-only kernel has a block each, below);
//     utterances never exchange data, so an utterance's result does not
//     depend on its batch mates;
//   * the A alternatives of a segment sit on the lanes (chunks of 32 when
//     A > 32); the carry lives in registers, replicated on every lane;
//   * max and sums over the row by warp shuffle (xor butterfly: a fixed
//     combination order, so results are deterministic); no shared memory
//     and no __syncthreads per segment;
//   * the mask is honoured exactly as the TPU kernel does: valid = m > 0.5,
//     the exp weight is multiplied by m, a segment with no valid arc
//     passes the carry through, and z is clamped to EPS;
//   * an out-of-range arc id in level_arcs is a masked slot: no input can
//     fault.
//
// sausage_loss_only starts from the raw (B, T, K) log-probs.  The TPU
// version builds a kappa-scaled, mean-centred cumsum grid over all T*K
// log-probs (six passes over 38 MB at the CG batch) and then reads three
// entries of it per arc.  Here an arc's acoustic score is its span sum,
// kappa * sum_{t=start}^{end-1} lp[t, label]: the same number before
// rounding, with no endpoint cancellation (the only reason for the
// centring), read from the W*T/S log-probs the arcs cover instead of all
// T*K.  One block per utterance:
//   * gather: every (segment, alternative) slot loads its arc fields and
//     sums its span in parallel, one thread a slot; a span longer than
//     kShortSpan frames is summed by a whole warp afterwards (lane j takes
//     frames j, j+32, ..., then an xor butterfly: a fixed order), so a
//     T-frame arc does not serialise one lane.  Scores, correctness and
//     mask go to shared memory (global scratch when S*W slots do not fit);
//     none of this waits on the carry;
//   * chain: warp 0 runs the S-segment recursion (segment_step, as the
//     forward kernel) over the gathered rows.  Frames are clamped to
//     [0, T], labels to [0, K), and an arc with end < start sums
//     -sum_{end}^{start-1} (the cumsum difference), so no input can fault.
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

// An (S, W) row of the gathered slots (shared memory or global scratch).
struct SlotRow {
  const float* sc;
  const float* co;
  const float* mk;
  __device__ void load(int w, float& s, float& c, float& m) const {
    s = sc[w];
    c = co[w];
    m = mk[w];
  }
  __device__ float weight_value(bool valid, float c, float carry_c) const {
    return valid ? c + carry_c : 0.f;
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

constexpr int kShortSpan = 32;  // longer spans are summed by a warp

// An arc's span [lo, hi) and sign after clamping (frames to [0, T]).
__device__ __forceinline__ void arc_span(int start, int end, int T, int& lo,
                                         int& hi, float& sign) {
  const int s = min(max(start, 0), T);
  const int e = min(max(end, 0), T);
  lo = min(s, e);
  hi = max(s, e);
  sign = e < s ? -1.f : 1.f;
}

// lp (B, T, K) f32; start/end/label (B, A) int32; lm/corr (B, A) f32;
// mask (B, A) bool (mask_is_bool) or f32; level_arcs (B, S, W) int32.
// scratch: (B, 4, S*W) floats when the slots do not fit in shared memory,
// else null.  Out: logz/cavg (B,).
__global__ void sausage_loss_only_kernel(
    const float* __restrict__ lp, const int* __restrict__ start,
    const int* __restrict__ end, const int* __restrict__ label,
    const float* __restrict__ lm, const float* __restrict__ corr,
    const void* __restrict__ mask, int mask_is_bool,
    const int* __restrict__ level_arcs, float* scratch, float* logz,
    float* cavg, float kappa, int T, int K, int A, int S, int W) {
  extern __shared__ __align__(16) float slots[];
  __shared__ int n_long;
  const long long b = blockIdx.x;
  const int SW = S * W;
  float* sc = scratch ? scratch + b * 4LL * SW : slots;
  float* co = sc + SW;
  float* mk = co + SW;
  int* longs = reinterpret_cast<int*>(mk + SW);
  lp += b * (long long)T * K;
  start += b * A;
  end += b * A;
  label += b * A;
  lm += b * A;
  corr += b * A;
  level_arcs += b * (long long)SW;
  if (threadIdx.x == 0) n_long = 0;
  __syncthreads();
  // gather: arc fields and short spans, one thread a slot
  for (int i = threadIdx.x; i < SW; i += blockDim.x) {
    const int a = level_arcs[i];
    float s = 0.f, c = 0.f, m = 0.f;
    if (a >= 0 && a < A) {
      c = corr[a];
      m = mask_is_bool
              ? (static_cast<const unsigned char*>(mask)[b * A + a] ? 1.f
                                                                    : 0.f)
              : static_cast<const float*>(mask)[b * A + a];
      if (m > 0.5f) {  // masked arcs never reach the recursion
        int lo, hi;
        float sign;
        arc_span(start[a], end[a], T, lo, hi, sign);
        if (hi - lo > kShortSpan) {
          longs[atomicAdd(&n_long, 1)] = i;  // summed below by a warp
        } else {
          const float* col = lp + min(max(label[a], 0), K - 1);
          float acc = 0.f;
#pragma unroll 4
          for (int t = lo; t < hi; ++t) acc += col[(long long)t * K];
          s = kappa * (sign * acc) + lm[a];
        }
      }
    }
    sc[i] = s;
    co[i] = c;
    mk[i] = m;
  }
  __syncthreads();
  // long spans: one warp each, lane j over frames lo+j, lo+j+32, ...
  const int lane = threadIdx.x & 31;
  for (int j = threadIdx.x >> 5; j < n_long; j += blockDim.x >> 5) {
    const int i = longs[j];
    const int a = level_arcs[i];
    int lo, hi;
    float sign;
    arc_span(start[a], end[a], T, lo, hi, sign);
    const float* col = lp + min(max(label[a], 0), K - 1);
    float acc = 0.f;
    for (int t = lo + lane; t < hi; t += 32) acc += col[(long long)t * K];
    acc = warp_sum(acc);
    if (lane == 0) sc[i] = kappa * (sign * acc) + lm[a];
  }
  __syncthreads();
  if (threadIdx.x >= 32) return;
  // the chain: S dependent segments over the gathered rows
  float in_log = 0.f, c_in = 0.f;
  NoWrite sink;
  for (int s = 0; s < S; ++s) {
    const long long r = (long long)s * W;
    segment_step(SlotRow{sc + r, co + r, mk + r}, W, in_log, c_in, sink);
  }
  if (lane == 0) {
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

int sausage_loss_only_launch(const float* lp, const int* start,
                             const int* end, const int* label,
                             const float* lm, const float* corr,
                             const void* mask, int mask_is_bool,
                             const int* level_arcs, float* scratch,
                             float* logz, float* cavg, float kappa, int B,
                             int T, int K, int A, int S, int W, int threads,
                             int smem_bytes, void* stream) {
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sausage_loss_only_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  sausage_loss_only_kernel<<<B, threads, smem_bytes,
                             (cudaStream_t)stream>>>(
      lp, start, end, label, lm, corr, mask, mask_is_bool, level_arcs,
      scratch, logz, cavg, kappa, T, K, A, S, W);
  return (int)cudaGetLastError();
}

}  // extern "C"
