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
// Forward and backward: a segment-parallel scan, not the TPU kernels'
// chain.  The TPU kernels run S dependent segment steps, each needing the
// carry (in_log, c_in) of the segment before.  In a sausage every arc of
// segment s follows every arc of segment s-1, so the carry enters every
// valid row value of segment s alike, row_a = sc_a + carry; it shifts the
// row's max by the same amount and cancels in exp(row - max).  Over the
// valid arcs (m > 0.5) of segment s:
//   new_in_log = in_log + lse_s,  lse_s = log(max(z_s, EPS)) + max sc,
//                                 z_s = sum_a exp(sc_a - max sc) * m_a,
//   new_c_in   = c_in + E_s,      E_s = sum_a w_a * corr_a,
// since the weights w = e / max(z, EPS) sum to 1 in a valid segment (its
// top arc alone gives z >= m > 0.5).  A segment with no valid arc passes
// the carry: lse_s = E_s = 0.  The backward's (out_log, c_out) sums the
// same pairs from the other end.  With P, C the inclusive prefix sums of
// (lse, E) and P', C' the inclusive suffix sums:
//   alpha[s, a] = sc + P_{s-1},  c_alpha[s, a] = corr + C_{s-1},
//   logZ = P_{S-1},              c_avg = C_{S-1},
//   beta[s, a]  = P'_{s+1},      c_beta[s, a]  = C'_{s+1}
// (0 past either end; NEG / 0 on masked arcs).  S dependent steps become S
// independent segment reductions and a log-depth scan: the same function
// as the TPU kernels, rounded no worse (the weights come from sc - max sc
// exactly, not from (sc + carry) - max rounded at ulp(|carry|)).  The DAG
// kernels (lattice_dag.cu) cannot share this: a DAG slot's predecessors
// are its own subset of earlier slots, so its carry is a logsumexp over
// that subset, different from slot to slot, and no level has one additive
// carry to scan.
//
// What bounds them on this card: latency.  At the training shape (B=32,
// S=50, A=3) the forward moves about 96 KB, a few hundredths of a
// microsecond at 3.35 TB/s, and does about 60,000 operations.
// The design keeps the latency to one load round trip per chunk of 32
// segments, a few shuffles and one store:
//   * one warp per utterance, four utterances per block; utterances never
//     exchange data, so an utterance's result does not depend on its
//     batch mates;
//   * segments on lanes: lane j takes segments j, j+32, ... (the backward
//     S-1-j, S-1-j-32, ...).  A lane reads its segment's A scores,
//     correctness values and mask once, through __restrict__ pointers (no
//     load waits behind an earlier store), straight from global memory in
//     groups of kGroup = 4 arcs whose loads are issued together, so a row
//     of A = 3 costs one round trip, not three.  No shared-memory staging:
//     at A = 3 a warp's loads of one array span 384 contiguous bytes, and
//     an L2 prefetch of the whole tile ahead of the chunks gained nothing
//     on the H100;
//   * segment_stats reduces the row in one pass in registers: a running
//     max, with the exp-sum and the weighted correctness sum rescaled
//     when the max moves (one expf an arc, any A, A = 40 included); the
//     mask as the TPU kernel: valid = m > 0.5, weights times m, z clamped
//     to EPS;
//   * warp_scan: an inclusive Hillis-Steele scan over the 32 lanes
//     (__shfl_up_sync by 1, 2, 4, 8, 16: a fixed order, so a repeat launch
//     gives the same bits), plus the carry of the chunks before; one more
//     shuffle gives the exclusive values, and lane 31's inclusive value is
//     the next chunk's carry; a fully masked utterance keeps the zero
//     carry;
//   * each lane writes its segment's row of outputs (the forward loads the
//     row again for it, a cache hit).  scan_segments (the
//     reduction, the scan and the carry over chunks) is shared by both
//     kernels; they differ only in direction and in what they write.
//
// sausage_loss_only keeps the TPU kernel's chain (segment_step) and its
// bits.  Its results are compared only with each other: candidate
// evaluation scores every CG iterate and the dtheta = 0 baseline through
// it, so the forward kernel's different rounding (the gradient stage)
// never enters that comparison.  It starts from the raw (B, T, K)
// log-probs.  The TPU version builds a kappa-scaled, mean-centred cumsum
// grid over all T*K log-probs (six passes over 38 MB at the CG batch) and
// then reads three entries of it per arc.  Here an arc's acoustic score is
// its span sum, kappa * sum_{t=start}^{end-1} lp[t, label]: the same
// number before rounding, with no endpoint cancellation (the only reason
// for the centring), read from the W*T/S log-probs the arcs cover instead
// of all T*K.  One block per utterance:
//   * gather: every (segment, alternative) slot loads its arc fields and
//     sums its span in parallel, one thread a slot; a span longer than
//     kShortSpan frames is summed by a whole warp afterwards (lane j takes
//     frames j, j+32, ..., then an xor butterfly: a fixed order), so a
//     T-frame arc does not serialise one lane.  Scores, correctness and
//     mask go to shared memory (global scratch when S*W slots do not fit);
//     none of this waits on the carry;
//   * chain: warp 0 runs the S-segment recursion (segment_step: the
//     alternatives of a segment on the lanes, the carry in registers, max
//     and sums by xor butterflies) over the gathered rows.  Frames are
//     clamped to [0, T], labels to [0, K), and an arc with end < start
//     sums -sum_{end}^{start-1} (the cumsum difference), so no input can
//     fault.
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

// ---------------------------------------------------------------------------
// forward and backward: the segment-parallel scan
// ---------------------------------------------------------------------------

// Alternatives whose loads a lane issues together: one memory round trip
// for up to kGroup arcs of a row (A = 3 takes one).
constexpr int kGroup = 4;

// v[i] = p[a0 + i] for a0 + i < A, else 0 (those loads are not issued)
__device__ __forceinline__ void load_group(const float* __restrict__ p,
                                           int a0, int A, float (&v)[kGroup]) {
#pragma unroll
  for (int i = 0; i < kGroup; ++i) v[i] = a0 + i < A ? p[a0 + i] : 0.f;
}

// (lse_s, E_s) of one segment's row of A alternatives, one pass in order
// of a: (0, 0) when no arc is valid.
struct SegStat {
  float lse;
  float e;
};

__device__ __forceinline__ SegStat segment_stats(
    const float* __restrict__ sc, const float* __restrict__ co,
    const float* __restrict__ mk, int A) {
  float mx = -INFINITY, z = 0.f, e = 0.f;
  bool any_valid = false;
  for (int a0 = 0; a0 < A; a0 += kGroup) {
    float m[kGroup], s[kGroup], c[kGroup];
    load_group(mk, a0, A, m);
    load_group(sc, a0, A, s);
    load_group(co, a0, A, c);
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      if (m[i] > 0.5f) {  // past A, m[i] = 0
        if (s[i] > mx) {  // a new max: rescale what was summed under the old
          const float r = expf(mx - s[i]);
          z = z * r + m[i];
          e = e * r + m[i] * c[i];
          mx = s[i];
        } else {
          const float p = expf(s[i] - mx) * m[i];
          z = z + p;
          e = e + p * c[i];
        }
        any_valid = true;
      }
    }
  }
  if (!any_valid) return {0.f, 0.f};
  const float zc = fmaxf(z, kEps);
  return {logf(zc) + mx, e / zc};
}

// Inclusive scan of v over the warp's lanes, Hillis-Steele in a fixed
// order.
__device__ __forceinline__ float warp_scan(float v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v = v + y;
  }
  return v;
}

// The (S, A) tile of one utterance, segment by segment on the lanes
// (kReverse: from the last segment).  For each segment s, calls
// write(r, p, c) on its lane with r = s * A and (p, c) the sums of
// (lse, E) over the segments before it in scan order; returns the sums
// over all S segments in (total_log, total_c).
template <bool kReverse, class Write>
__device__ __forceinline__ void scan_segments(
    const float* __restrict__ score, const float* __restrict__ corr,
    const float* __restrict__ mask, int S, int A, const Write& write,
    float& total_log, float& total_c) {
  const int lane = threadIdx.x & 31;
  float carry_log = 0.f, carry_c = 0.f;
  for (int base = 0; base < S; base += 32) {
    const int j = base + lane;
    const long long r = (long long)(kReverse ? S - 1 - j : j) * A;
    SegStat st{0.f, 0.f};
    if (j < S) st = segment_stats(score + r, corr + r, mask + r, A);
    const float inc_log = warp_scan(st.lse) + carry_log;
    const float inc_c = warp_scan(st.e) + carry_c;
    float ex_log = __shfl_up_sync(kFull, inc_log, 1);
    float ex_c = __shfl_up_sync(kFull, inc_c, 1);
    if (lane == 0) {
      ex_log = carry_log;
      ex_c = carry_c;
    }
    if (j < S) write(r, ex_log, ex_c);
    carry_log = __shfl_sync(kFull, inc_log, 31);
    carry_c = __shfl_sync(kFull, inc_c, 31);
  }
  total_log = carry_log;
  total_c = carry_c;
}

// alpha = sc + P_{s-1}, c_alpha = corr + C_{s-1} on valid arcs
struct ForwardWrite {
  const float* __restrict__ score;
  const float* __restrict__ corr;
  const float* __restrict__ mask;
  float* __restrict__ alpha;
  float* __restrict__ c_alpha;
  int A;
  __device__ void operator()(long long r, float p, float c) const {
    for (int a0 = 0; a0 < A; a0 += kGroup) {
      float m[kGroup], s[kGroup], co[kGroup];
      load_group(mask + r, a0, A, m);
      load_group(score + r, a0, A, s);
      load_group(corr + r, a0, A, co);
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        if (a0 + i < A) {
          const bool valid = m[i] > 0.5f;
          alpha[r + a0 + i] = valid ? s[i] + p : kNeg;
          c_alpha[r + a0 + i] = valid ? co[i] + c : 0.f;
        }
      }
    }
  }
};

// beta = P'_{s+1}, c_beta = C'_{s+1} on valid arcs
struct BackwardWrite {
  const float* __restrict__ mask;
  float* __restrict__ beta;
  float* __restrict__ c_beta;
  int A;
  __device__ void operator()(long long r, float p, float c) const {
    for (int a0 = 0; a0 < A; a0 += kGroup) {
      float m[kGroup];
      load_group(mask + r, a0, A, m);
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        if (a0 + i < A) {
          const bool valid = m[i] > 0.5f;
          beta[r + a0 + i] = valid ? p : kNeg;
          c_beta[r + a0 + i] = valid ? c : 0.f;
        }
      }
    }
  }
};

__global__ void sausage_forward_kernel(const float* __restrict__ score,
                                       const float* __restrict__ corr,
                                       const float* __restrict__ mask,
                                       float* __restrict__ alpha,
                                       float* __restrict__ c_alpha,
                                       float* __restrict__ logz,
                                       float* __restrict__ cavg, int B,
                                       int S, int A) {
  const int b = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= B) return;  // whole warp leaves together
  const long long o = (long long)b * S * A;
  float in_log, c_in;
  scan_segments<false>(
      score + o, corr + o, mask + o, S, A,
      ForwardWrite{score + o, corr + o, mask + o, alpha + o, c_alpha + o, A},
      in_log, c_in);
  if ((threadIdx.x & 31) == 0) {
    logz[b] = in_log;
    cavg[b] = c_in;
  }
}

__global__ void sausage_backward_kernel(const float* __restrict__ score,
                                        const float* __restrict__ corr,
                                        const float* __restrict__ mask,
                                        float* __restrict__ beta,
                                        float* __restrict__ c_beta, int B,
                                        int S, int A) {
  const int b = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= B) return;
  const long long o = (long long)b * S * A;
  float out_log, c_out;
  scan_segments<true>(score + o, corr + o, mask + o, S, A,
                      BackwardWrite{mask + o, beta + o, c_beta + o, A},
                      out_log, c_out);
}

// ---------------------------------------------------------------------------
// loss-only: the TPU kernel's chain over gathered slots
// ---------------------------------------------------------------------------

// One segment of the recursion over a row of A alternatives held by the
// warp.  Row::load(a, score, corr, m) fetches alternative a; the row value
// is score + carry_log on valid arcs and NEG elsewhere.  Updates
// (carry_log, carry_c) as the TPU kernel does; the weighted sum is over
// Row::weight_value (c_row = corr + c_in on valid arcs).
template <class Row>
__device__ __forceinline__ void segment_step(const Row& row, int A,
                                             float& carry_log,
                                             float& carry_c) {
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
  for (int s = 0; s < S; ++s) {
    const long long r = (long long)s * W;
    segment_step(SlotRow{sc + r, co + r, mk + r}, W, in_log, c_in);
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
