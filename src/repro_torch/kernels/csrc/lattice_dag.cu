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
// level costs at least one round trip to the memory that holds the state
// plus a barrier, whatever the width; the bytes each kernel must move are
// a few MB at the service's shapes (microseconds at 3.35 TB/s).
//
// Shared by all three:
//   * one thread block per utterance (grid = B); blocks never exchange
//     data, so a request's result does not depend on its batch mates;
//   * each slot reduces its P predecessors (S successors) sequentially
//     with exactly the semantics of _masked_lse_rows: valid = x > NEG/2,
//     pivot 0 for an all-masked row, lse = NEG and all-zero weights for
//     such a row, max(z, EPS) guards (masked_lse_row below);
//   * deterministic: no atomics on values; the final-arc reduction is
//     folded by one warp in flat level-major order (ballot over 32 slots,
//     then the final lanes in ascending order), so it depends only on the
//     sequence of final slots;
//   * an out-of-range position in pidx/sidx reads NEG / 0 (the dump slot),
//     an out-of-range arc id in level_arcs is an empty slot, and a gather
//     position into the cumsum grid is clamped: no input can fault.
//
// dag_forward: a compacted recursion in shared memory.  A streaming
// session's bucket has W = A (resume collapses completed levels into
// level 0), e.g. 204 levels x 750 slots for 750 arcs: about 4 valid slots
// a level.  Striding every level over all W slots in global memory, as
// dag_backward and dag_loss_only still do, spends each of the L dependent
// steps on empty slots and on two dependent L2 loads per predecessor.  So:
//   1. prepass: the block scans the ok flags in flat level-major order
//      (ballots and one block scan per chunk) and gives each valid slot a
//      compact id 1..N; level l's valid slots are then the contiguous ids
//      off[l]+1 .. off[l+1].  A position -> id map (global scratch, L*W+1
//      ints) sends the dump slot, out-of-range positions, non-valid slots
//      and predecessors on the slot's own or a later level (not yet
//      computed when the slot is: NEG / 0, as in the plain version) to
//      the reserved id 0, which holds NEG / 0;
//   2. the compact state -- alpha (starting as own), c_alpha (starting as
//      corr), start/final flags, translated predecessor rows and the level
//      offsets, (9 + 4P) bytes a valid slot -- goes to shared memory when
//      it fits (about 5,000 slots at P = 9), else to global scratch the
//      wrapper allocates (the kernel decides after its prepass: N depends
//      on the data); the same code, compiled once for each place;
//   3. chain: level by level over the compact ranges, each slot through
//      masked_lse_row (same passes, same row order), so alpha and c_alpha
//      are bit-identical to the per-slot global-memory recursion.  When
//      no level has more than 32 slots that take a step (start slots take
//      none), warp 0 runs the whole chain with __syncwarp() between
//      levels while the other warps write the empty slots' NEG / 0 into
//      the outputs; else every level ends in a block barrier and the block
//      writes the NEG / 0 after the chain;
//   4. fold over the final slots in compact (= flat level-major) order,
//      the same sequential fold as before; the valid slots' alpha /
//      c_alpha are scattered into the (L*W+1) outputs over the NEG / 0.
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

// ---------------------------------------------------------------------------
// dag_forward: the compacted recursion (see the top of the file)
// ---------------------------------------------------------------------------

constexpr int kScanItems = 32;  // ok flags per lane per prepass chunk

// Entry of the position -> compact id map: q + 1 for a valid slot, ~q
// (negative) for any other, q = the number of valid slots before it.
__device__ __forceinline__ int map_id(int m) { return m > 0 ? m : 0; }
__device__ __forceinline__ int map_prefix(int m) { return m > 0 ? m - 1 : ~m; }

// Bytes of the compact state for N valid slots (kept equal to
// lattice_fb.dag_forward_state_bytes).
__host__ __device__ __forceinline__ long long compact_bytes(long long N,
                                                            int L, int P) {
  return 9 * (N + 1) + 4LL * (L + 1) + 4 * N * P;
}

// One utterance's compact state: ids 1..N, id 0 reserved (NEG / 0).
struct Compact {
  float* x;             // (N+1) alpha; own until the slot is computed
  float* c;             // (N+1) c_alpha; corr until the slot is computed
  int* off;             // (L+1) level l holds ids off[l]+1 .. off[l+1]
  int* pred;            // (N*P) predecessor ids, id i's row at (i-1)*P
  unsigned char* flag;  // (N+1) bit 0 start, bit 1 final

  __device__ Compact(unsigned char* base, int N, int L, int P) {
    x = reinterpret_cast<float*>(base);
    c = x + (N + 1);
    off = reinterpret_cast<int*>(c + (N + 1));
    pred = off + (L + 1);
    flag = reinterpret_cast<unsigned char*>(pred + (long long)N * P);
  }
};

// forward row over the compact arrays: predecessor ids into x / c
struct CompactRow {
  const float* xs;
  const float* cs;
  const int* ids;
  __device__ float x(int j) const { return xs[ids[j]]; }
  __device__ float c(int j) const { return cs[ids[j]]; }
};

// One slot's step: masked_lse_row over its predecessor row.
__device__ __forceinline__ void forward_slot(const Compact& st, int id,
                                             int P) {
  if (st.flag[id] & 1) return;  // start: alpha = own, c_alpha = corr + 0
  float in_log, c_in;
  masked_lse_row(CompactRow{st.x, st.c, st.pred + (long long)(id - 1) * P},
                 P, in_log, c_in);
  st.x[id] = st.x[id] + in_log;
  st.c[id] = st.c[id] + c_in;
}

// Phases 2-4 of one utterance on its compact state at `base`: shared
// memory (kShared, so the compiler emits shared-memory loads) or global
// scratch, the same code.
template <bool kShared>
__device__ __forceinline__ void compact_forward(
    unsigned char* base, int N, const float* __restrict__ own,
    const float* __restrict__ corr, const float* __restrict__ start,
    const float* __restrict__ fin, const int* __restrict__ pidx,
    const int* __restrict__ map, const int* __restrict__ pos, float* ab,
    float* cb, float* logz, float* cavg, int L, int W, int P,
    int* wide_level) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const Compact st(base, N, L, P);
  for (int l = threadIdx.x; l <= L; l += blockDim.x)
    st.off[l] = map_prefix(map[(long long)l * W]);  // l = L: the dump slot
  if (threadIdx.x == 0) {
    st.x[0] = kNeg;
    st.c[0] = 0.f;
    st.flag[0] = 0;
  }
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    const long long s = pos[i];
    const bool is_start = is_set(start[s]);
    st.x[i + 1] = own[s];
    st.c[i + 1] = is_start ? corr[s] + 0.f : corr[s];
    st.flag[i + 1] = (is_start ? 1 : 0) | (is_set(fin[s]) ? 2 : 0);
    if (is_start) continue;
    // only earlier levels hold computed values; the slot's own level, a
    // later one, the dump slot and out-of-range positions read id 0
    const long long level_start = (s / W) * W;
    const int* row = pidx + s * P;
    int* out = st.pred + (long long)i * P;
    for (int j = 0; j < P; ++j) {
      const int p = row[j];
      out[j] = (p >= 0 && p < level_start) ? map_id(map[p]) : 0;
    }
  }
  __syncthreads();

  // 3. the chain of levels.  A level is wide when more than 32 of its
  // slots take a step: start slots take none (a resume lattice's
  // collapsed level 0 holds only start slots), so they do not count.
  for (int l = warp; l < L; l += nwarps) {
    const int hi = st.off[l + 1];
    int steps = 0;
    for (int first = st.off[l] + 1; first <= hi; first += 32) {
      const int id = first + lane;
      steps += __popc(__ballot_sync(0xffffffffu,
                                    id <= hi && !(st.flag[id] & 1)));
    }
    if (steps > 32 && lane == 0) *wide_level = 1;
  }
  __syncthreads();
  const bool wide = *wide_level;
  if (wide || warp == 0) {  // the whole block, or warp 0 alone
    const int team = wide ? blockDim.x : 32;
    for (int l = 0; l < L; ++l) {
      for (int id = st.off[l] + 1 + threadIdx.x; id <= st.off[l + 1];
           id += team)
        forward_slot(st, id, P);
      if (wide)
        __syncthreads();
      else
        __syncwarp();
    }
  }
  // the empty slots' NEG / 0 into the outputs: by the warps the chain
  // leaves idle while warp 0 runs it, else by the block after it
  if (wide || warp > 0) {
    const int skip = wide ? 0 : 32;
    for (long long s = (long long)threadIdx.x - skip; s <= (long long)L * W;
         s += blockDim.x - skip) {
      ab[s] = kNeg;
      cb[s] = 0.f;
    }
  }
  __syncthreads();

  // 4. fold over the final slots in compact (flat level-major) order:
  // order-free exact max, then warp 0 adds exp-sums and weighted
  // correctness lane by lane in ascending order
  if (warp == 0) {
    float m = kNeg;
    for (int id = 1 + lane; id <= N; id += 32) {
      if (st.flag[id] & 2) {
        const float x = st.x[id];
        if (x > kHalfNeg) m = fmaxf(m, x);
      }
    }
    for (int d = 16; d > 0; d >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, d));
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
      unsigned mask = __ballot_sync(0xffffffffu, v);
      while (mask) {
        const int j = __ffs(mask) - 1;
        z += __shfl_sync(0xffffffffu, e, j);
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
      unsigned mask = __ballot_sync(0xffffffffu, v);
      while (mask) {
        const int j = __ffs(mask) - 1;
        c += __shfl_sync(0xffffffffu, t, j);
        mask &= mask - 1;
      }
    }
    if (lane == 0) {
      *logz = has ? fmaxf(logf(zc) + m0, kNeg) : kNeg;
      *cavg = c;
    }
  }

  // write-out: the valid slots' alpha / c_alpha over the NEG / 0
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    const long long s = pos[i];
    ab[s] = st.x[i + 1];
    cb[s] = st.c[i + 1];
  }
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
  ok += o;
  int* map = map_buf + b * (LW + 1);
  int* pos = pos_buf + b * LW;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const unsigned below = (1u << lane) - 1u;

  // 1. prepass: compact ids by a block-wide exclusive scan of the ok
  // flags, chunk by chunk; warp w takes 32 * kScanItems consecutive slots
  // of a chunk, lane-interleaved, so every load is coalesced.
  if (threadIdx.x == 0) wide_level = 0;
  int running = 0;
  const long long chunk = (long long)blockDim.x * kScanItems;
  for (long long first0 = 0; first0 < LW; first0 += chunk) {
    const long long first = first0 + (long long)warp * 32 * kScanItems + lane;
    bool v[kScanItems];
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      const long long s = first + 32 * k;
      v[k] = s < LW && is_set(ok[s]);
    }
    unsigned masks[kScanItems];
    int cnt = 0;
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      masks[k] = __ballot_sync(0xffffffffu, v[k]);
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
  const int N = running;
  if (threadIdx.x == 0) map[LW] = ~N;  // the dump slot
  __syncthreads();

  // 2-4. the compact state in shared memory when it fits
  float* ab = abuf + b * (LW + 1);
  float* cb = cbuf + b * (LW + 1);
  if (compact_bytes(N, L, P) <= smem_bytes)
    compact_forward<true>(smem, N, own + o, corr + o, start + o, fin + o,
                          pidx + o * P, map, pos, ab, cb, logz + b,
                          cavg + b, L, W, P, &wide_level);
  else
    compact_forward<false>(gstate + b * gstride, N, own + o, corr + o,
                           start + o, fin + o, pidx + o * P, map, pos, ab,
                           cb, logz + b, cavg + b, L, W, P, &wide_level);
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
                       const int* pidx, int* map, int* pos, void* gstate,
                       long long gstride, float* abuf, float* cbuf,
                       float* logz, float* cavg, int B, int L, int W, int P,
                       int threads, int smem_bytes, void* stream) {
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        dag_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  dag_forward_kernel<<<B, threads, smem_bytes, (cudaStream_t)stream>>>(
      own, corr, start, ok, fin, pidx, map, pos,
      static_cast<unsigned char*>(gstate), gstride, abuf, cbuf, logz, cavg,
      L, W, P, smem_bytes);
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
