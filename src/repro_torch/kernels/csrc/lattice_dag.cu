// General-DAG lattice kernels for Hopper (sm_90a): forward, backward and
// the fused loss-only forward.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/lattice_fb.py:
//   dag_forward_kernel   <- dag_forward   (:419, body _dag_fwd_kernel :331)
//   dag_backward_kernel  <- dag_backward  (:465, body _dag_bwd_kernel :375)
//   dag_loss_only_kernel <- dag_loss_only (:563, body _dag_loss_only_kernel
//                                          :499, and the host prologue
//                                          that builds its cumsum grid)
//
// What bounds them on this card: the chain of L dependent levels, not
// bytes and not arithmetic.  Level l reads what level l-1 wrote (l+1 for
// the backward), so a level costs at least one round trip to the memory
// that holds the state plus a barrier, whatever the width; the bytes each
// kernel must move are a few MB at the service's shapes (microseconds at
// 3.35 TB/s).  A level holds few valid slots: a streaming session's bucket
// has W = A (e.g. 204 levels x 750 slots, about 4 valid a level), the
// service bucket (8, 250, 9) about 4 of 9.  So all three kernels run one
// compacted recursion over the valid slots only, in shared memory:
//
//   1. prepass (compact_prepass): the block scans the valid flags in flat
//      level-major order (ballots and one block scan per chunk) and gives
//      each valid slot a compact id 1..N; level l's valid slots are then
//      the contiguous ids off[l]+1 .. off[l+1].  A position -> id map
//      (global scratch, L*W+1 ints) sends the dump slot, out-of-range
//      positions and non-valid slots to the reserved id 0 (NEG / 0);
//   2. the compact state (struct Compact) -- the recursion's value and
//      correctness per id, flags, the neighbour rows translated entry by
//      entry, the level offsets -- goes to shared memory when it fits, else
//      to global scratch the wrapper allocates (the kernel decides after
//      its prepass: N depends on the data); the same code, compiled once
//      for each place.  A row keeps only neighbours the recursion has
//      already computed: predecessors on an earlier level (forward),
//      successors on a later level (backward).  Every other entry -- the
//      slot's own level included, which the plain version reads as NEG / 0
//      because that level is not written yet -- reads id 0, so no slot
//      ever reads a slot of its own level;
//   3. chain (run_chain): level by level over the compact ranges (L-1 down
//      to 0 for the backward), each slot through masked_lse_row (same
//      passes, same row order as the plain per-slot recursion).  When no
//      level has more than 32 slots that take a step (start slots in the
//      forward, final slots in the backward take none), warp 0 runs the
//      whole chain with __syncwarp() between levels while the other warps
//      write the empty slots' NEG / 0 into the outputs; else every level
//      ends in a block barrier and the block writes the NEG / 0 after;
//   4. dag_forward and dag_loss_only fold over the final slots in compact
//      (= flat level-major) order, sequentially on warp 0; dag_forward and
//      dag_backward scatter the valid slots' values into their (L*W+1)
//      outputs over the NEG / 0.
//
// The three differ only in where a slot's inputs come from:
//   * dag_forward: level-major own / corr / start / ok / final, pidx;
//   * dag_backward: the same with final slots as the ones that take no
//     step (beta = 0) and sidx; a row entry is beta + own and c_beta + corr
//     of the successor, as _dag_bwd_kernel reads it;
//   * dag_loss_only: the raw (B, T, K) log-probs and arc-layout fields
//     through level_arcs (a slot is valid when its arc id is in [0, A) and
//     arc_mask is set; start / final are ANDed with it).  A valid slot's
//     score is kappa * sum_{t=start}^{end-1} lp[t, label] + lm, summed
//     directly from the log-probs under its span (no cumsum grid: no
//     endpoint cancellation to centre away, and only the log-probs the arcs
//     cover are read), as lattice_sausage.cu's sausage_loss_only does:
//     frames clamped to [0, T], labels to [0, K), end < start gives the
//     negated sum, and a span longer than kShortSpan frames is summed by
//     the whole warp (lane j over frames j, j+32, ..., then an xor
//     butterfly: a fixed order).  Only (logZ, c_avg) leave the kernel.
//
// Shared by all three:
//   * one thread block per utterance (grid = B); blocks never exchange
//     data, so a request's result does not depend on its batch mates;
//   * each slot reduces its P predecessors (S successors) sequentially
//     with exactly the semantics of _masked_lse_rows: valid = x > NEG/2,
//     pivot 0 for an all-masked row, lse = NEG and all-zero weights for
//     such a row, max(z, EPS) guards (masked_lse_row below);
//   * deterministic: no atomics; the final-arc fold depends only on the
//     sequence of final slots;
//   * an out-of-range position in pidx/sidx reads NEG / 0, an out-of-range
//     arc id in level_arcs is an empty slot, frames and labels are clamped:
//     no input can fault.
//
// The kernels allocate nothing and launch on the stream they are given.
// Plain C interface (ctypes); each launcher returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr float kHalfNeg = -5e29f;   // NEG * 0.5: the validity threshold
constexpr float kEps = 1e-30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kScanItems = 32;  // valid flags per lane per prepass chunk
constexpr int kShortSpan = 32;  // longer spans are summed by a warp

__device__ __forceinline__ bool is_set(float f) { return f > 0.5f; }

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

// Entry of the position -> compact id map: q + 1 for a valid slot, ~q
// (negative) for any other, q = the number of valid slots before it.
__device__ __forceinline__ int map_id(int m) { return m > 0 ? m : 0; }
__device__ __forceinline__ int map_prefix(int m) { return m > 0 ? m - 1 : ~m; }

// Bytes of the compact state for N valid slots with rows of R entries
// (kept equal to lattice_fb.dag_forward_state_bytes and
// dag_backward_state_bytes): the backward also holds own and corr.
__host__ __device__ __forceinline__ long long compact_bytes(long long N,
                                                            int L, int R,
                                                            bool backward) {
  return (backward ? 17 : 9) * (N + 1) + 4LL * (L + 1) + 4 * N * R;
}

// One utterance's compact state: ids 1..N, id 0 reserved (NEG / 0).
struct Compact {
  float* x;             // (N+1) alpha (own until computed), or beta
  float* c;             // (N+1) c_alpha (corr until computed), or c_beta
  float* own;           // (N+1) backward only: the slot's own score ...
  float* corr;          // (N+1) ... and correctness
  int* off;             // (L+1) level l holds ids off[l]+1 .. off[l+1]
  int* row;             // (N*R) neighbour ids, id i's row at (i-1)*R
  unsigned char* flag;  // (N+1) bit 0 takes no step, bit 1 final (fold)

  __device__ Compact(unsigned char* base, int N, int L, int R,
                     bool backward) {
    x = reinterpret_cast<float*>(base);
    c = x + (N + 1);
    own = backward ? c + (N + 1) : nullptr;
    corr = backward ? own + (N + 1) : nullptr;
    off = reinterpret_cast<int*>(backward ? corr + (N + 1) : c + (N + 1));
    row = off + (L + 1);
    flag = reinterpret_cast<unsigned char*>(row + (long long)N * R);
  }
};

// 1. prepass: compact ids by a block-wide exclusive scan of valid(s),
// chunk by chunk; warp w takes 32 * kScanItems consecutive slots of a
// chunk, lane-interleaved, so every load is coalesced.  Writes map
// (LW+1, the dump slot at LW) and pos (the N valid positions in order);
// returns N.
template <class Valid>
__device__ __forceinline__ int compact_prepass(const Valid& valid,
                                               long long LW, int* map,
                                               int* pos, int* warp_tot) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  int running = 0;
  const long long chunk = (long long)blockDim.x * kScanItems;
  for (long long first0 = 0; first0 < LW; first0 += chunk) {
    const long long first = first0 + (long long)warp * 32 * kScanItems + lane;
    bool v[kScanItems];
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      const long long s = first + 32 * k;
      v[k] = s < LW && valid(s);
    }
    unsigned masks[kScanItems];
    int cnt = 0;
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      masks[k] = __ballot_sync(kFull, v[k]);
      cnt += __popc(masks[k]);
    }
    if (lane == 0) warp_tot[warp] = cnt;
    __syncthreads();
    int pre = running, tot = 0;
    for (int i = 0; i < nwarps; ++i) {
      const int t = warp_tot[i];
      pre += i < warp ? t : 0;
      tot += t;
    }
    __syncthreads();  // warp_tot is rewritten by the next chunk
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      const long long s = first + 32 * k;
      const int q = pre + __popc(masks[k] & below);
      if (s < LW) {
        map[s] = v[k] ? q + 1 : ~q;
        if (v[k]) pos[q] = (int)s;
      }
      pre += __popc(masks[k]);
    }
    running += tot;
  }
  if (threadIdx.x == 0) map[LW] = ~running;  // the dump slot
  __syncthreads();
  return running;
}

// 2. the level offsets and the reserved id 0 of the compact state.
__device__ __forceinline__ void compact_init(const Compact& st,
                                             const int* map, int L, int W) {
  for (int l = threadIdx.x; l <= L; l += blockDim.x)
    st.off[l] = map_prefix(map[(long long)l * W]);  // l = L: the dump slot
  if (threadIdx.x == 0) {
    st.x[0] = kNeg;
    st.c[0] = 0.f;
    st.flag[0] = 0;
    if (st.own) {
      st.own[0] = 0.f;
      st.corr[0] = 0.f;
    }
  }
}

// A neighbour row of R positions translated into compact ids: positions in
// [lo, hi) keep the id of their slot (0 when it is not valid), all others
// read id 0.
__device__ __forceinline__ void translate_row(const int* src, int* out,
                                              int R, long long lo,
                                              long long hi, const int* map) {
  for (int j = 0; j < R; ++j) {
    const int p = src[j];
    out[j] = (p >= lo && p < hi) ? map_id(map[p]) : 0;
  }
}

// forward row over the compact arrays: predecessor ids into x / c
struct CompactRow {
  const float* xs;
  const float* cs;
  const int* ids;
  __device__ float x(int j) const { return xs[ids[j]]; }
  __device__ float c(int j) const { return cs[ids[j]]; }
};

// backward row: each successor's beta + own score / c_beta + corr
struct CompactBwdRow {
  const float* bs;
  const float* cbs;
  const float* own;
  const float* corr;
  const int* ids;
  __device__ float x(int j) const { return bs[ids[j]] + own[ids[j]]; }
  __device__ float c(int j) const { return cbs[ids[j]] + corr[ids[j]]; }
};

// One forward step: alpha = own + lse over the predecessors (start slots
// keep alpha = own, c_alpha = corr + 0).
__device__ __forceinline__ void forward_slot(const Compact& st, int id,
                                             int P) {
  if (st.flag[id] & 1) return;
  float in_log, c_in;
  masked_lse_row(CompactRow{st.x, st.c, st.row + (long long)(id - 1) * P},
                 P, in_log, c_in);
  st.x[id] = st.x[id] + in_log;
  st.c[id] = st.c[id] + c_in;
}

// One backward step: beta = lse over the successors (final slots keep
// beta = 0, c_beta = 0).
__device__ __forceinline__ void backward_slot(const Compact& st, int id,
                                              int S) {
  if (st.flag[id] & 1) return;
  float out_log, c_out;
  masked_lse_row(CompactBwdRow{st.x, st.c, st.own, st.corr,
                               st.row + (long long)(id - 1) * S},
                 S, out_log, c_out);
  st.x[id] = out_log;
  st.c[id] = c_out;
}

// 3. the chain of levels, first to last (last to first when kReverse).  A
// level is wide when more than 32 of its slots take a step; then the whole
// block runs the chain with a barrier a level, else warp 0 alone with
// __syncwarp().  Returns whether it was wide; the caller's warps that did
// not run the chain go on at once.
template <bool kReverse, class Step>
__device__ __forceinline__ bool run_chain(const Compact& st, int L,
                                          int* wide_level, const Step& step) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int l = warp; l < L; l += nwarps) {
    const int hi = st.off[l + 1];
    int steps = 0;
    for (int first = st.off[l] + 1; first <= hi; first += 32) {
      const int id = first + lane;
      steps += __popc(__ballot_sync(kFull, id <= hi && !(st.flag[id] & 1)));
    }
    if (steps > 32 && lane == 0) *wide_level = 1;
  }
  __syncthreads();
  const bool wide = *wide_level;
  if (wide || warp == 0) {  // the whole block, or warp 0 alone
    const int team = wide ? blockDim.x : 32;
    for (int i = 0; i < L; ++i) {
      const int l = kReverse ? L - 1 - i : i;
      for (int id = st.off[l] + 1 + threadIdx.x; id <= st.off[l + 1];
           id += team)
        step(id);
      if (wide)
        __syncthreads();
      else
        __syncwarp();
    }
  }
  return wide;
}

// The empty slots' NEG / 0 into the (LW+1) outputs: by the warps the chain
// leaves idle while warp 0 runs it, else by the block after it; then a
// block barrier.
__device__ __forceinline__ void fill_empty(bool wide, float* ob, float* cb,
                                           long long LW) {
  if (wide || (threadIdx.x >> 5) > 0) {
    const int skip = wide ? 0 : 32;
    for (long long s = (long long)threadIdx.x - skip; s <= LW;
         s += blockDim.x - skip) {
      ob[s] = kNeg;
      cb[s] = 0.f;
    }
  }
  __syncthreads();
}

// 4. fold over the final slots in compact (flat level-major) order:
// order-free exact max, then warp 0 adds exp-sums and weighted
// correctness lane by lane in ascending order.
__device__ __forceinline__ void fold_finals(const Compact& st, int N,
                                            float* logz, float* cavg) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  float m = kNeg;
  for (int id = 1 + lane; id <= N; id += 32) {
    if (st.flag[id] & 2) {
      const float x = st.x[id];
      if (x > kHalfNeg) m = fmaxf(m, x);
    }
  }
  for (int d = 16; d > 0; d >>= 1)
    m = fmaxf(m, __shfl_xor_sync(kFull, m, d));
  const bool has = m > kHalfNeg;
  const float m0 = has ? m : 0.f;
  float z = 0.f;
  for (int first = 1; first <= N; first += 32) {
    const int id = first + lane;
    float e = 0.f;
    bool v = false;
    if (id <= N && (st.flag[id] & 2)) {
      const float x = st.x[id];
      if (x > kHalfNeg) {
        v = true;
        e = expf(x - m0);
      }
    }
    unsigned mask = __ballot_sync(kFull, v);
    while (mask) {
      const int j = __ffs(mask) - 1;
      z += __shfl_sync(kFull, e, j);
      mask &= mask - 1;
    }
  }
  const float zc = fmaxf(z, kEps);
  float c = 0.f;
  for (int first = 1; first <= N; first += 32) {
    const int id = first + lane;
    float t = 0.f;
    bool v = false;
    if (id <= N && (st.flag[id] & 2)) {
      const float x = st.x[id];
      if (x > kHalfNeg) {
        v = true;
        t = (expf(x - m0) / zc) * st.c[id];
      }
    }
    unsigned mask = __ballot_sync(kFull, v);
    while (mask) {
      const int j = __ffs(mask) - 1;
      c += __shfl_sync(kFull, t, j);
      mask &= mask - 1;
    }
  }
  if (lane == 0) {
    *logz = has ? fmaxf(logf(zc) + m0, kNeg) : kNeg;
    *cavg = c;
  }
}

// the valid slots' values over the NEG / 0 of the outputs
__device__ __forceinline__ void scatter_valid(const Compact& st,
                                              const int* pos, int N,
                                              float* ob, float* cb) {
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    const long long s = pos[i];
    ob[s] = st.x[i + 1];
    cb[s] = st.c[i + 1];
  }
}

// Phases 2-4 of each kernel on the compact state at `base`: shared memory
// (kShared, so that the compiler emits shared-memory loads) or global
// scratch, the same code.

template <bool kShared>
__device__ __forceinline__ void forward_compact(
    unsigned char* base, int N, const float* __restrict__ own,
    const float* __restrict__ corr, const float* __restrict__ start,
    const float* __restrict__ fin, const int* __restrict__ pidx,
    const int* __restrict__ map, const int* __restrict__ pos, float* ab,
    float* cb, float* logz, float* cavg, int L, int W, int P,
    int* wide_level) {
  const Compact st(base, N, L, P, false);
  compact_init(st, map, L, W);
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    const long long s = pos[i];
    const bool is_start = is_set(start[s]);
    st.x[i + 1] = own[s];
    st.c[i + 1] = is_start ? corr[s] + 0.f : corr[s];
    st.flag[i + 1] = (is_start ? 1 : 0) | (is_set(fin[s]) ? 2 : 0);
    if (!is_start)  // only earlier levels hold computed values
      translate_row(pidx + s * P, st.row + (long long)i * P, P, 0,
                    (s / W) * W, map);
  }
  __syncthreads();
  const bool wide = run_chain<false>(
      st, L, wide_level, [&](int id) { forward_slot(st, id, P); });
  fill_empty(wide, ab, cb, (long long)L * W);
  fold_finals(st, N, logz, cavg);
  scatter_valid(st, pos, N, ab, cb);
}

template <bool kShared>
__device__ __forceinline__ void backward_compact(
    unsigned char* base, int N, const float* __restrict__ own,
    const float* __restrict__ corr, const float* __restrict__ fin,
    const int* __restrict__ sidx, const int* __restrict__ map,
    const int* __restrict__ pos, float* bb, float* cb, int L, int W, int S,
    int* wide_level) {
  const long long LW = (long long)L * W;
  const Compact st(base, N, L, S, true);
  compact_init(st, map, L, W);
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    const long long s = pos[i];
    const bool is_final = is_set(fin[s]);
    st.x[i + 1] = 0.f;
    st.c[i + 1] = 0.f;
    st.own[i + 1] = own[s];
    st.corr[i + 1] = corr[s];
    st.flag[i + 1] = is_final ? 1 : 0;
    if (!is_final)  // only later levels hold computed values
      translate_row(sidx + s * S, st.row + (long long)i * S, S,
                    (s / W + 1) * W, LW, map);
  }
  __syncthreads();
  const bool wide = run_chain<true>(
      st, L, wide_level, [&](int id) { backward_slot(st, id, S); });
  fill_empty(wide, bb, cb, LW);
  scatter_valid(st, pos, N, bb, cb);
}

// An arc's span [lo, hi) and sign after clamping (frames to [0, T]), as
// lattice_sausage.cu's arc_span.
__device__ __forceinline__ void arc_span(int start, int end, int T, int& lo,
                                         int& hi, float& sign) {
  const int s = min(max(start, 0), T);
  const int e = min(max(end, 0), T);
  lo = min(s, e);
  hi = max(s, e);
  sign = e < s ? -1.f : 1.f;
}

// An arc-layout flag stored as bool (one byte) or f32 (set above 0.5).
struct ArcFlag {
  const void* p;
  bool is_bool;
  __device__ bool operator()(long long a) const {
    return is_bool ? static_cast<const unsigned char*>(p)[a] != 0
                   : is_set(static_cast<const float*>(p)[a]);
  }
};

// The arc-layout inputs of one utterance of dag_loss_only.
struct Arcs {
  const float* lp;  // (T, K)
  const int* start;
  const int* end;
  const int* label;
  const float* lm;
  const float* corr;
  ArcFlag mask, is_start, is_final;
  const int* level_arcs;  // (L*W)
  int A;
  __device__ bool valid(long long s) const {
    const int a = level_arcs[s];
    return a >= 0 && a < A && mask(a);
  }
};

template <bool kShared>
__device__ __forceinline__ void loss_only_compact(
    unsigned char* base, int N, const Arcs& arcs, const int* __restrict__ pidx,
    const int* __restrict__ map, const int* __restrict__ pos, float* logz,
    float* cavg, float kappa, int T, int K, int L, int W, int P,
    int* wide_level) {
  const int lane = threadIdx.x & 31;
  const Compact st(base, N, L, P, false);
  compact_init(st, map, L, W);
  // the valid slots' fields, rows and span sums; warp-uniform trip count,
  // so that each warp then sums its long spans together
  for (int first = 0; first < N; first += blockDim.x) {
    const int i = first + threadIdx.x;
    int lo = 0, hi = 0, lab = 0;
    float sign = 1.f, lm = 0.f;
    bool is_long = false;
    if (i < N) {
      const long long s = pos[i];
      const int a = arcs.level_arcs[s];
      const bool is_start = arcs.is_start(a);
      const float co = arcs.corr[a];
      st.c[i + 1] = is_start ? co + 0.f : co;
      st.flag[i + 1] = (is_start ? 1 : 0) | (arcs.is_final(a) ? 2 : 0);
      if (!is_start)
        translate_row(pidx + s * P, st.row + (long long)i * P, P, 0,
                      (s / W) * W, map);
      arc_span(arcs.start[a], arcs.end[a], T, lo, hi, sign);
      lab = min(max(arcs.label[a], 0), K - 1);
      lm = arcs.lm[a];
      is_long = hi - lo > kShortSpan;
      if (!is_long) {
        const float* col = arcs.lp + lab;
        float acc = 0.f;
#pragma unroll 4
        for (int t = lo; t < hi; ++t) acc += col[(long long)t * K];
        st.x[i + 1] = kappa * (sign * acc) + lm;
      }
    }
    // long spans: the whole warp, lane j over frames lo+j, lo+j+32, ...
    unsigned longs = __ballot_sync(kFull, is_long);
    while (longs) {
      const int j = __ffs(longs) - 1;
      longs &= longs - 1;
      const int jlo = __shfl_sync(kFull, lo, j);
      const int jhi = __shfl_sync(kFull, hi, j);
      const float* col = arcs.lp + __shfl_sync(kFull, lab, j);
      float acc = 0.f;
      for (int t = jlo + lane; t < jhi; t += 32) acc += col[(long long)t * K];
      for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(kFull, acc, o);
      if (lane == j) st.x[i + 1] = kappa * (sign * acc) + lm;
    }
  }
  __syncthreads();
  run_chain<false>(st, L, wide_level,
                   [&](int id) { forward_slot(st, id, P); });
  __syncthreads();
  fold_finals(st, N, logz, cavg);
}

// own/corr/start/ok/fin (B, L*W), pidx (B, L*W, P).  Scratch: map
// (B, L*W+1) and pos (B, L*W) ints; gstate (B x gstride bytes) holds the
// compact state of an utterance whose state exceeds smem_bytes (null when
// the wrapper knows every utterance fits).  Out: abuf/cbuf (B, L*W+1),
// logz/cavg (B,).
__global__ void __launch_bounds__(512)
dag_forward_kernel(const float* __restrict__ own,
                   const float* __restrict__ corr,
                   const float* __restrict__ start,
                   const float* __restrict__ ok,
                   const float* __restrict__ fin,
                   const int* __restrict__ pidx, int* __restrict__ map_buf,
                   int* __restrict__ pos_buf, unsigned char* gstate,
                   long long gstride, float* __restrict__ abuf,
                   float* __restrict__ cbuf, float* __restrict__ logz,
                   float* __restrict__ cavg, int L, int W, int P,
                   int smem_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int warp_tot[32];
  __shared__ int wide_level;
  const long long LW = (long long)L * W;
  const long long b = blockIdx.x;
  const long long o = b * LW;
  int* map = map_buf + b * (LW + 1);
  int* pos = pos_buf + b * LW;
  if (threadIdx.x == 0) wide_level = 0;
  const float* okb = ok + o;
  const int N = compact_prepass(
      [=](long long s) { return is_set(okb[s]); }, LW, map, pos, warp_tot);
  float* ab = abuf + b * (LW + 1);
  float* cb = cbuf + b * (LW + 1);
  if (compact_bytes(N, L, P, false) <= smem_bytes)
    forward_compact<true>(smem, N, own + o, corr + o, start + o, fin + o,
                          pidx + o * P, map, pos, ab, cb, logz + b,
                          cavg + b, L, W, P, &wide_level);
  else
    forward_compact<false>(gstate + b * gstride, N, own + o, corr + o,
                           start + o, fin + o, pidx + o * P, map, pos, ab,
                           cb, logz + b, cavg + b, L, W, P, &wide_level);
}

// own/corr/fin/ok (B, L*W), sidx (B, L*W, S); scratch as dag_forward's.
// Out: bbuf/cbbuf (B, L*W+1).
__global__ void __launch_bounds__(512)
dag_backward_kernel(const float* __restrict__ own,
                    const float* __restrict__ corr,
                    const float* __restrict__ fin,
                    const float* __restrict__ ok,
                    const int* __restrict__ sidx, int* __restrict__ map_buf,
                    int* __restrict__ pos_buf, unsigned char* gstate,
                    long long gstride, float* __restrict__ bbuf,
                    float* __restrict__ cbbuf, int L, int W, int S,
                    int smem_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int warp_tot[32];
  __shared__ int wide_level;
  const long long LW = (long long)L * W;
  const long long b = blockIdx.x;
  const long long o = b * LW;
  int* map = map_buf + b * (LW + 1);
  int* pos = pos_buf + b * LW;
  if (threadIdx.x == 0) wide_level = 0;
  const float* okb = ok + o;
  const int N = compact_prepass(
      [=](long long s) { return is_set(okb[s]); }, LW, map, pos, warp_tot);
  float* bb = bbuf + b * (LW + 1);
  float* cb = cbbuf + b * (LW + 1);
  if (compact_bytes(N, L, S, true) <= smem_bytes)
    backward_compact<true>(smem, N, own + o, corr + o, fin + o,
                           sidx + o * S, map, pos, bb, cb, L, W, S,
                           &wide_level);
  else
    backward_compact<false>(gstate + b * gstride, N, own + o, corr + o,
                            fin + o, sidx + o * S, map, pos, bb, cb, L, W, S,
                            &wide_level);
}

// lp (B, T, K) f32; start/end/label (B, A) int32; lm/corr (B, A) f32;
// mask/is_start/is_final (B, A) bool or f32 (bit 0 / 1 / 2 of bool_flags
// set: bool); level_arcs (B, L*W) int32; pidx (B, L*W, P).  Scratch as
// dag_forward's.  Out: logz/cavg (B,).
__global__ void __launch_bounds__(512)
dag_loss_only_kernel(const float* __restrict__ lp,
                     const int* __restrict__ start,
                     const int* __restrict__ end,
                     const int* __restrict__ label,
                     const float* __restrict__ lm,
                     const float* __restrict__ corr, const void* mask,
                     const void* is_start, const void* is_final,
                     int bool_flags, const int* __restrict__ level_arcs,
                     const int* __restrict__ pidx, int* __restrict__ map_buf,
                     int* __restrict__ pos_buf, unsigned char* gstate,
                     long long gstride, float* __restrict__ logz,
                     float* __restrict__ cavg, float kappa, int T, int K,
                     int A, int L, int W, int P, int smem_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int warp_tot[32];
  __shared__ int wide_level;
  const long long LW = (long long)L * W;
  const long long b = blockIdx.x;
  const long long oa = b * A;
  const auto flag_at = [&](const void* p, int bit) {
    const bool is_bool = (bool_flags >> bit) & 1;
    return ArcFlag{static_cast<const char*>(p) + oa * (is_bool ? 1 : 4),
                   is_bool};
  };
  const Arcs arcs{lp + b * (long long)T * K, start + oa, end + oa,
                  label + oa, lm + oa, corr + oa, flag_at(mask, 0),
                  flag_at(is_start, 1), flag_at(is_final, 2),
                  level_arcs + b * LW, A};
  int* map = map_buf + b * (LW + 1);
  int* pos = pos_buf + b * LW;
  if (threadIdx.x == 0) wide_level = 0;
  const int N = compact_prepass(
      [=](long long s) { return arcs.valid(s); }, LW, map, pos, warp_tot);
  if (compact_bytes(N, L, P, false) <= smem_bytes)
    loss_only_compact<true>(smem, N, arcs, pidx + b * LW * P, map, pos,
                            logz + b, cavg + b, kappa, T, K, L, W, P,
                            &wide_level);
  else
    loss_only_compact<false>(gstate + b * gstride, N, arcs,
                             pidx + b * LW * P, map, pos, logz + b,
                             cavg + b, kappa, T, K, L, W, P, &wide_level);
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, int smem_bytes) {
  if (smem_bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
}

}  // namespace

extern "C" {

const char* lattice_dag_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int dag_forward_launch(const float* own, const float* corr,
                       const float* start, const float* ok, const float* fin,
                       const int* pidx, int* map, int* pos, void* gstate,
                       long long gstride, float* abuf, float* cbuf,
                       float* logz, float* cavg, int B, int L, int W, int P,
                       int threads, int smem_bytes, void* stream) {
  const cudaError_t err = allow_smem(dag_forward_kernel, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  dag_forward_kernel<<<B, threads, smem_bytes, (cudaStream_t)stream>>>(
      own, corr, start, ok, fin, pidx, map, pos,
      static_cast<unsigned char*>(gstate), gstride, abuf, cbuf, logz, cavg,
      L, W, P, smem_bytes);
  return (int)cudaGetLastError();
}

int dag_backward_launch(const float* own, const float* corr, const float* fin,
                        const float* ok, const int* sidx, int* map, int* pos,
                        void* gstate, long long gstride, float* bbuf,
                        float* cbbuf, int B, int L, int W, int S, int threads,
                        int smem_bytes, void* stream) {
  const cudaError_t err = allow_smem(dag_backward_kernel, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  dag_backward_kernel<<<B, threads, smem_bytes, (cudaStream_t)stream>>>(
      own, corr, fin, ok, sidx, map, pos,
      static_cast<unsigned char*>(gstate), gstride, bbuf, cbbuf, L, W, S,
      smem_bytes);
  return (int)cudaGetLastError();
}

int dag_loss_only_launch(const float* lp, const int* start, const int* end,
                         const int* label, const float* lm, const float* corr,
                         const void* mask, const void* is_start,
                         const void* is_final, int bool_flags,
                         const int* level_arcs, const int* pidx, int* map,
                         int* pos, void* gstate, long long gstride,
                         float* logz, float* cavg, float kappa, int B, int T,
                         int K, int A, int L, int W, int P, int threads,
                         int smem_bytes, void* stream) {
  const cudaError_t err = allow_smem(dag_loss_only_kernel, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  dag_loss_only_kernel<<<B, threads, smem_bytes, (cudaStream_t)stream>>>(
      lp, start, end, label, lm, corr, mask, is_start, is_final, bool_flags,
      level_arcs, pidx, map, pos, static_cast<unsigned char*>(gstate),
      gstride, logz, cavg, kappa, T, K, A, L, W, P, smem_bytes);
  return (int)cudaGetLastError();
}

}  // extern "C"
