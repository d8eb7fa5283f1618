// The derivatives of sliding-window causal attention for Hopper (sm_90a),
// bf16 storage, on the tensor cores: the backward's dq kernel and dk/dv
// kernel, and the forward-mode jvp kernel; every product a wgmma, every
// hd-wide tile a TMA load, one producer warpgroup and two consumer
// warpgroups a block.
//
// q, g (the output's cotangent), dq, tq, tout: (B, T, H, hd); k, v, dk, dv,
// tk, tv: (B, T, K, hd); all contiguous bf16, hd a multiple of 8 (TMA's
// 16-byte strides) and <= 256.  Query t attends to the keys t - window ...
// t (window + 1 keys, clipped at 0), s_tj = scale q_t.k_j with scale =
// 1/sqrt(hd), P = softmax_j(s).  With dP = g V^T, D_t = sum_j P_tj dP_tj and
// dS = P (dP - D): dq = scale dS K, dk = scale dS^T q, dv = P^T g, the
// function of kernels/ref.py::swa_attention_vjp_ref.  With ds = scale (tq
// K^T + q TK^T) and dsbar_t = sum_j P_tj ds_tj: tout = P (ds - dsbar) V + P
// tv, the function of kernels/ref.py::swa_attention_jvp_ref.  Query head h
// reads kv head h / (H / K): MQA/GQA K/V are never repeated.
//
// Replaces no TPU kernel: the reference trains through the jnp
// windowed_attention (src/repro/models/layers.py:232), which JAX
// differentiates itself.  It takes the bf16 inputs of the CUDA-core kernels
// in swa_attention_bwd.cu, which stay the exact f32 path (the tensor cores
// would round f32 inputs), as swa_attention.cu does for the forward.
//
// What bounds them on this card: operations.  At recurrentgemma-9b's
// training shape (B 2, T 4096, H 16, K 1, hd 256, window 2048) the dq
// kernel's useful work is 0.31 TFLOP, the dk/dv kernel's 0.41 TFLOP and the
// jvp's 0.62 TFLOP of bf16 products, against 0.1 GB of inputs and outputs.
// The design puts all of it on the tensor cores, built from the forward's
// pieces (swa_attention_sm90.cu):
//   * dq kernel: the forward's tiles (kernels/swa_attention.py::
//     swa_geometry): 128 (query, head) rows of one kv head, 128 / G queries
//     x the G heads (G = H / K), walking the 64-key tiles of the band.  Q
//     and g come in once; K and V tiles arrive through a ring of TMA slots,
//     K and V each a slot of their own, so a slot is freed as soon as its
//     last product has read it.  Each consumer warpgroup owns 64 rows.
//     Pass 1: S = Q K^T and dP = g V^T (wgmma m64n64k16, both operands in
//     shared memory), an online softmax in f32 giving each row's
//     log-sum-exp and D = sum_j P dP from P in f32 (never rowsum(g o O) with
//     a bf16 O).  Pass 2: S and dP again, dS = P (dP - D) in f32, dq += dS K
//     with dS from registers and K the transposed B operand.  LSE and D go
//     out as a (B, K, T, G) f32 side output, so a dk/dv walked tile's rows
//     are one contiguous run of it;
//   * dk/dv kernel: one block per (64-key tile, kv head, batch row).  K and
//     V come in once; the producer rings walked tiles of Q and g: 64 rows of
//     (query, head) pairs, 64 / G' queries x G' = min(G, 64) heads of the kv
//     group (G > 64 tiles the heads), over the queries s ... s + 63 + window.
//     The two consumer warpgroups split the outputs: one forms S^T = K Q^T
//     and adds dv += P^T g; the other forms S^T and dP^T = V g^T, dS^T =
//     P^T (dP^T - D) and adds dk += dS^T q.  P^T = exp(scale S^T - LSE),
//     masked pairs exactly 0, rows past T or past the group given LSE =
//     +1e30; g and q are the transposed B operands.  The dv warpgroup
//     stages each walked tile's LSE and D in shared memory for both.  dk
//     and dv stay in registers: no atomics;
//   * jvp kernel: the dq kernel with other operands.  Q and TQ come in
//     once; the ring carries K and TK a tile in pass 1, K, TK, V and TV in
//     pass 2, each its own slot.  Pass 1: S = Q K^T and ds = TQ K^T + Q TK^T
//     (the second product continues the first's accumulator), each row's
//     log-sum-exp and dsbar.  Pass 2: S and ds again in the same order, P
//     and X = P (scale ds - dsbar) in f32, tout += X V + P TV into one f32
//     accumulator (two hd-wide ones, for P V and P ds V apart as the
//     CUDA-core kernel's one pass keeps them, would not fit a warpgroup's
//     registers at hd 256).  At hd 256 it walks key tiles of 32 (m64n32
//     scores): with 64, S and ds (or P and X's halves) beside the 128
//     accumulator registers made ptxas spill.  At window 0 P = 1 and X = 0
//     exactly, so tout is tv's bits;
//   * P, dS and X at f32 accuracy: before each product that takes them as
//     the A operand they are split, X_hi = bf16(X) and X_lo = bf16(X -
//     X_hi), and two wgmma add both into the f32 accumulator (the forward's
//     split P); the operands from memory are bf16, so every product is exact
//     and only the order of the sums differs from the plain version;
//   * setmaxnreg gives the consumers 240 registers (an hd-wide accumulator
//     is 128 of them at hd 256) and the producer 24;
//   * every sum runs in a fixed order, so two launches on the same inputs
//     give the same bits.
//
// Shared memory at hd 256: dq Q 64 KB + g 64 KB + three 32 KB ring slots
// (225 KB); jvp Q and TQ 128 KB + six 16 KB slots of 32-key tiles (225 KB);
// dk/dv K 32 KB + V 32 KB + two stages of Q and g (64 KB each, 193 KB); one
// block of 384 threads an SM.  The tensor maps are encoded on the host for
// each launch (cuTensorMapEncodeTiled through the CUDA runtime, so no
// -lcuda) and passed as __grid_constant__ parameters.  The kernels allocate
// nothing and launch on the stream they are given.  Plain C interface
// (ctypes); a launcher returns cudaGetLastError(), or a code >=
// kEncodeError when a tensor map could not be encoded.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

namespace {

constexpr int kRows = 128;             // dq: (query, head) rows of a tile
constexpr int kBK = 64;                // keys of a K/V tile; rows of a walked tile
constexpr int kThreads = 384;          // producer + 2 consumer warpgroups
constexpr int kQChunk = kRows * 128;   // bytes of 128 rows x 64 bf16
constexpr int kTile = kBK * 128;       // bytes of 64 rows x 64 bf16
constexpr float kNeg = -1e30f;
constexpr float kBig = 1e30f;          // the LSE of a row that is not there
constexpr int kEncodeError = 100000;   // + CUresult of a failed encode

// slots of the dq and jvp kernels' ring (one K, V, TK or TV tile each) and
// Q/g stages of the dk/dv kernel's ring, by NC = hd_pad / 64
template <int NC>
__host__ __device__ constexpr int dq_slots() {
  return NC == 4 ? 3 : NC == 2 ? 6 : 8;
}
template <int NC>
__host__ __device__ constexpr int dkdv_stages() {
  return NC == 4 ? 2 : 4;
}

template <int NC>
constexpr int dq_smem_bytes() {
  return 1024 /* alignment slack */ + 2 * NC * kQChunk
         + dq_slots<NC>() * NC * kTile + (1 + 2 * dq_slots<NC>()) * 8;
}

// The jvp walks key tiles of jvp_keys keys: 32 at hd_pad 256, where its
// scores' two fragments beside the hd-wide accumulator would not fit a
// consumer's registers at 64 (ptxas spilled), else 64.  Its ring slots (one
// K, TK, V or TV tile each) fill what Q and TQ leave.
template <int NC>
__host__ __device__ constexpr int jvp_keys() {
  return NC == 4 ? 32 : kBK;
}
template <int NC>
__host__ __device__ constexpr int jvp_slots() {
  return NC == 4 ? 6 : dq_slots<NC>();
}
template <int NC>
constexpr int jvp_smem_bytes() {
  return 1024 + 2 * NC * kQChunk + jvp_slots<NC>() * NC * jvp_keys<NC>() * 128
         + (1 + 2 * jvp_slots<NC>()) * 8;
}

template <int NC>
constexpr int dkdv_smem_bytes() {
  return 1024 + 2 * NC * kTile + dkdv_stages<NC>() * 2 * NC * kTile
         + 2 * 128 * 4 /* LSE and D */ + (1 + 2 * dkdv_stages<NC>()) * 8;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- TMA --------------------------------------------------------------------

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::
          "r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ---- wgmma ------------------------------------------------------------------

// Shared-memory matrix descriptor, 128B swizzle: start address, leading
// and stride byte offsets (16-byte units), layout type 1 = SWIZZLE_128B.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(lbo >> 4) << 16)
         | (static_cast<uint64_t>(sbo >> 4) << 32)
         | (static_cast<uint64_t>(1) << 62);
}

// K-major operand (rows of 128 bytes = 64 bf16 of hd each, 8-row groups
// 1024 bytes apart); the 16-wide k step inside the 128-byte swizzle atom
// moves the start address by 32 bytes.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return sw128_desc(addr, 16, 1024);
}

// MN-major operand (a 64-row tile x 64 hd columns, each row 128 bytes, the
// rows being the product's k dimension): one 64-column swizzle atom across
// N, 8-row groups 1024 bytes apart along K; a 16-row k step moves the start
// address by 2048 bytes.
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t addr) {
  return sw128_desc(addr, 1024, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from reading or moving registers that an asynchronous
// wgmma reads or writes (final only after wgmma_wait_all).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int KK>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[KK][4]) {
#pragma unroll
  for (int kk = 0; kk < KK; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[kk][e])::"memory");
}

// d (64 x 64, f32) (+)= A (64 x 16, smem, K-major) . B (16 x 64, smem,
// K-major), bf16 inputs.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 32, f32) (+)= A (64 x 16, smem, K-major) . B (16 x 32, smem,
// K-major), bf16 inputs: the first 16 registers of m64n64's layout.
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, f32) += A (64 x 16, registers) . B (16 x 64, smem,
// MN-major, transposed), bf16 inputs.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// Accumulator layout of wgmma m64n64 (f32), per thread of a warpgroup:
// register i holds row 16 * warp + lane / 4 + 8 * ((i >> 1) & 1), column
// 8 * (i >> 2) + 2 * (lane % 4) + (i & 1).  A row's 64 columns are spread
// over the 4 lanes of a quad, 16 each (m64n32: registers 0 .. 15, 8 each).
//
// X = X_hi + X_lo as A fragments of m64nNk16 (16 columns a k step): a0 =
// (row, columns 2q, 2q+1), a1 = (row + 8, same), a2 = (row, columns 2q + 8,
// 2q + 9), a3 = (row + 8, same): registers 8kk .. 8kk + 7 of the
// accumulator layout; N score registers give N / 8 k steps.
template <int N>
__device__ __forceinline__ void split_frags(const float (&x)[N],
                                            uint32_t (&hi)[N / 8][4],
                                            uint32_t (&lo)[N / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x0 = x[8 * kk + 2 * e], x1 = x[8 * kk + 2 * e + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
      const float2 hf = __bfloat1622float2(h);
      hi[kk][e] = bf16x2_bits(h);
      lo[kk][e] = bf16x2_bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
    }
}

// acc[c] += (X_hi + X_lo) . B, B the MN-major tile of 16 KK rows at
// b_addr (NC chunks of 64 hd columns, chunk_bytes apart)
template <int NC, int KK>
__device__ __forceinline__ void add_split_product(float (&acc)[NC][32],
                                                  uint32_t (&hi)[KK][4],
                                                  uint32_t (&lo)[KK][4],
                                                  uint32_t b_addr,
                                                  int chunk_bytes) {
#pragma unroll
  for (int c = 0; c < NC; ++c) fence_regs(acc[c]);
  fence_frags(hi);
  fence_frags(lo);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KK; ++kk)
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const uint64_t db = mnmajor_desc(b_addr + c * chunk_bytes + kk * 2048);
      wgmma_rs(acc[c], hi[kk], db);
      wgmma_rs(acc[c], lo[kk], db);
    }
  wgmma_commit();
  wgmma_wait_all();
#pragma unroll
  for (int c = 0; c < NC; ++c) fence_regs(acc[c]);
}

// d = A . B^T (kAdd: d += A . B^T) over NC chunks of 64 hd columns, A a
// K-major 64-row tile, B one of 2 N rows (A's chunks a_chunk bytes apart,
// B's b_chunk), started without waiting
template <int NC, bool kAdd = false, int N = 32>
__device__ __forceinline__ void start_scores(float (&d)[N], uint32_t a_addr,
                                             int a_chunk, uint32_t b_addr,
                                             int b_chunk) {
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss(d, kmajor_desc(a_addr + c * a_chunk + kk * 32),
               kmajor_desc(b_addr + c * b_chunk + kk * 32),
               kAdd || (c | kk) != 0);
}

// ---- dq and jvp: tiles of (query, head) rows --------------------------------

// the band mask of a score tile of N registers: bit i for register i (rows
// trow, keys k0 + column)
template <bool kMasked, int N>
__device__ __forceinline__ uint32_t band_mask(const int (&trow)[2],
                                              const bool (&rvalid)[2],
                                              int k0, int quad, int seq,
                                              int window) {
  if (!kMasked) return 0xffffffffu;
  uint32_t ok = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int h = (i >> 1) & 1;
    const int kpos = k0 + 8 * (i >> 2) + 2 * quad + (i & 1);
    const bool v = rvalid[h] && kpos <= trow[h] &&
                   kpos >= trow[h] - window && kpos < seq;
    ok |= static_cast<uint32_t>(v) << i;
  }
  return ok;
}

// Block (x, y, b) of the dq and jvp kernels: queries t0 .. t0 + qt - 1 x
// heads h0 .. h0 + gt - 1 of kv head kvh in batch row b; its keys k_begin
// .. k_end - 1 in n_tiles tiles of `keys` (swa_geometry's key_span at kBK)
struct RowTile {
  int b, kvh, ht, t0, h0, k_begin, k_end, n_tiles;

  __device__ RowTile(int seq, int group, int window, int qt, int gt,
                     int head_tiles, int keys)
      : b(blockIdx.z),
        kvh(blockIdx.y / head_tiles),
        ht(blockIdx.y % head_tiles),
        t0(blockIdx.x * qt),
        h0(kvh * group + ht * gt),
        k_begin(max(0, t0 - window)),
        k_end(min(t0 + qt, seq)),
        n_tiles((k_end - k_begin + keys - 1) / keys) {}
};

// A consumer thread's two rows of the tile (registers i with (i >> 1) & 1
// == h hold row h) and the band mask of a score tile over them
struct ThreadRows {
  int trow[2], gidx[2];   // query; head within the kv group
  bool rvalid[2];         // a real (query, head) pair
  bool full_rows;         // every row of the tile is one
  int quad, t_lo, t_hi;

  __device__ ThreadRows(const RowTile& tile, int seq, int group, int qt,
                        int gt) {
    const int cw = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    quad = lane & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 64 * cw + 16 * warp + (lane >> 2) + 8 * h;
      const int tq = r / gt, gi = r % gt;
      trow[h] = tile.t0 + tq;
      gidx[h] = tile.ht * gt + gi;
      rvalid[h] = tq < qt && trow[h] < seq && gidx[h] < group;
    }
    full_rows = qt * gt == kRows && tile.t0 + qt <= seq &&
                tile.ht * gt + gt <= group;
    t_lo = tile.t0;
    t_hi = tile.k_end - 1;
  }

  // the mask of a score tile of N registers (2 N keys from k0)
  template <int N = 32>
  __device__ __forceinline__ uint32_t mask(int k0, int seq,
                                           int window) const {
    const bool interior = full_rows && k0 >= t_hi - window &&
                          k0 + 2 * N - 1 <= t_lo;
    return interior
               ? band_mask<false, N>(trow, rvalid, k0, quad, seq, window)
               : band_mask<true, N>(trow, rvalid, k0, quad, seq, window);
  }

  // out's rows = mul acc, rounded to bf16; two adjacent columns a store
  template <int NC>
  __device__ __forceinline__ void store(__nv_bfloat16* __restrict__ out,
                                        const float (&acc)[NC][32],
                                        const RowTile& tile, int seq,
                                        int heads, int group, int hd,
                                        float mul) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!rvalid[h]) continue;
      __nv_bfloat16* row =
          out + ((static_cast<long long>(tile.b) * seq + trow[h]) * heads +
                 tile.kvh * group + gidx[h]) * hd;
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int col = 64 * c + 8 * jj + 2 * quad;
          if (col < hd)
            *reinterpret_cast<__nv_bfloat162*>(row + col) =
                __floats2bfloat162_rn(acc[c][4 * jj + 2 * h] * mul,
                                      acc[c][4 * jj + 2 * h + 1] * mul);
        }
    }
  }
};

// pass 1 on one tile of N score registers: the online softmax's max m and
// sum l, and dsum = sum_j exp(s - m) x (dP in dq, scale ds in the jvp),
// rescaled as m moves
template <int N>
__device__ __forceinline__ void stats_tile(float (&sc)[N],
                                           const float (&x)[N], uint32_t ok,
                                           float (&m)[2], float (&l)[2],
                                           float (&dsum)[2], float scale) {
  float mt[2] = {kNeg, kNeg};
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int h = (i >> 1) & 1;
    sc[i] = ((ok >> i) & 1u) ? sc[i] * scale : kNeg;
    mt[h] = fmaxf(mt[h], sc[i]);
  }
  float mn[2], ls[2] = {0.f, 0.f}, lds[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 1));
    mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 2));
    mn[h] = fmaxf(m[h], mt[h]);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int h = (i >> 1) & 1;
    const bool v = (ok >> i) & 1u;
    const float e = v ? expf(sc[i] - mn[h]) : 0.f;
    ls[h] += e;
    lds[h] += v ? e * x[i] : 0.f;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    ls[h] += __shfl_xor_sync(0xffffffffu, ls[h], 1);
    ls[h] += __shfl_xor_sync(0xffffffffu, ls[h], 2);
    lds[h] += __shfl_xor_sync(0xffffffffu, lds[h], 1);
    lds[h] += __shfl_xor_sync(0xffffffffu, lds[h], 2);
    const float corr = expf(m[h] - mn[h]);   // 1 while the row saw no key
    l[h] = l[h] * corr + ls[h];
    dsum[h] = dsum[h] * corr + lds[h];
    m[h] = mn[h];
  }
}

// each row's log-sum-exp and dsum / l from pass 1's m, l and dsum
__device__ __forceinline__ void finish_stats(const float (&m)[2],
                                             const float (&l)[2],
                                             const float (&dsum)[2],
                                             float (&lse)[2],
                                             float (&mean)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float safe = fmaxf(l[h], 1e-30f);
    lse[h] = m[h] + logf(safe);
    mean[h] = dsum[h] / safe;
  }
}

template <int NC>
__global__ void __launch_bounds__(kThreads, 1)
swa_dq_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_g,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   __nv_bfloat16* __restrict__ dq, float* __restrict__ lse_out,
                   float* __restrict__ d_out, int seq, int heads,
                   int kv_heads, int hd, int window, int qt, int gt,
                   int head_tiles, float scale) {
  constexpr int kSlots = dq_slots<NC>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* q_s = base;
  uint8_t* g_s = q_s + NC * kQChunk;
  uint8_t* ring = g_s + NC * kQChunk;
  uint64_t* qg_full = reinterpret_cast<uint64_t*>(ring + kSlots * NC * kTile);
  uint64_t* full = qg_full + 1;
  uint64_t* empty = full + kSlots;

  const int group = heads / kv_heads;
  const RowTile tile(seq, group, window, qt, gt, head_tiles, kBK);
  const int n_tiles = tile.n_tiles;

  if (threadIdx.x == 0) {
    mbar_init(qg_full, 1);
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * 128);   // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: Q and g once, then K_j, V_j of both passes ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(qg_full, 2 * NC * 128 * qt * gt);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        tma_load_4d(q_s + c * kQChunk, &tm_q, qg_full, c * 64, tile.h0,
                    tile.t0, tile.b);
        tma_load_4d(g_s + c * kQChunk, &tm_g, qg_full, c * 64, tile.h0,
                    tile.t0, tile.b);
      }
      const int items = 4 * n_tiles;
      for (int i = 0; i < items; ++i) {
        const int s = i % kSlots;
        if (i >= kSlots) mbar_wait(&empty[s], ((i / kSlots) & 1) ^ 1);
        mbar_expect_tx(&full[s], NC * kTile);
        const int k0 = tile.k_begin + ((i >> 1) % n_tiles) * kBK;
        const CUtensorMap* map = (i & 1) ? &tm_v : &tm_k;
#pragma unroll
        for (int c = 0; c < NC; ++c)
          tma_load_4d(ring + (s * NC + c) * kTile, map, &full[s], c * 64,
                      tile.kvh, k0, tile.b);
      }
    }
  } else {
    // ---- consumers: 64 rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const ThreadRows rows(tile, seq, group, qt, gt);
    const int cw = wg - 1;
    const uint32_t q_addr = smem_u32(q_s) + cw * (kQChunk / 2);
    const uint32_t g_addr = smem_u32(g_s) + cw * (kQChunk / 2);
    const uint32_t ring_addr = smem_u32(ring);

    mbar_wait(qg_full, 0);
    float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f}, dsum[2] = {0.f, 0.f};
    int item = 0;
    // pass 1: each row's log-sum-exp and D
    for (int j = 0; j < n_tiles; ++j, item += 2) {
      const int k0 = tile.k_begin + j * kBK;
      const int sk = item % kSlots, sv = (item + 1) % kSlots;
      mbar_wait(&full[sk], (item / kSlots) & 1);
      mbar_wait(&full[sv], ((item + 1) / kSlots) & 1);
      float sc[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
      fence_regs(sc);
      fence_regs(dp);
      wgmma_fence();
      start_scores<NC>(sc, q_addr, kQChunk, ring_addr + sk * NC * kTile,
                       kTile);
      start_scores<NC>(dp, g_addr, kQChunk, ring_addr + sv * NC * kTile,
                       kTile);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      fence_regs(dp);
      mbar_arrive(&empty[sk]);
      mbar_arrive(&empty[sv]);
      stats_tile(sc, dp, rows.mask(k0, seq, window), m, l, dsum, scale);
    }
    float lse[2], dd[2];
    finish_stats(m, l, dsum, lse, dd);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (rows.quad == 0 && rows.rvalid[h]) {
        const long long at =
            ((static_cast<long long>(tile.b) * kv_heads + tile.kvh) * seq +
             rows.trow[h]) * group + rows.gidx[h];
        lse_out[at] = lse[h];
        d_out[at] = dd[h];
      }
    }

    // pass 2: dS = P (dP - D), dq += dS K
    float acc[NC][32];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
    for (int j = 0; j < n_tiles; ++j, item += 2) {
      const int k0 = tile.k_begin + j * kBK;
      const int sk = item % kSlots, sv = (item + 1) % kSlots;
      mbar_wait(&full[sk], (item / kSlots) & 1);
      mbar_wait(&full[sv], ((item + 1) / kSlots) & 1);
      float sc[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
      fence_regs(sc);
      fence_regs(dp);
      wgmma_fence();
      start_scores<NC>(sc, q_addr, kQChunk, ring_addr + sk * NC * kTile,
                       kTile);
      start_scores<NC>(dp, g_addr, kQChunk, ring_addr + sv * NC * kTile,
                       kTile);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      fence_regs(dp);
      mbar_arrive(&empty[sv]);           // V is read by dP alone
      const uint32_t ok = rows.mask(k0, seq, window);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int h = (i >> 1) & 1;
        const bool v = (ok >> i) & 1u;
        const float p = v ? expf(sc[i] * scale - lse[h]) : 0.f;
        sc[i] = v ? p * (dp[i] - dd[h]) : 0.f;
      }
      uint32_t hi[4][4], lo[4][4];
      split_frags(sc, hi, lo);
      add_split_product<NC>(acc, hi, lo, ring_addr + sk * NC * kTile, kTile);
      mbar_arrive(&empty[sk]);
    }
    // dq = scale acc
    rows.store<NC>(dq, acc, tile, seq, heads, group, hd, scale);
  }
}

// The jvp's scores of one key tile (N registers: 2 N keys), the same wgmma
// order in both passes: S = Q K^T into sc and ds = TQ K^T + Q TK^T (one
// accumulator chain), K and TK the tiles at k_addr and tk_addr
template <int NC, int N>
__device__ __forceinline__ void jvp_scores(float (&sc)[N], float (&ds)[N],
                                           uint32_t q_addr, uint32_t tq_addr,
                                           uint32_t k_addr,
                                           uint32_t tk_addr) {
  constexpr int kItem = NC * 2 * N * 128;   // bytes of a K or TK tile
  constexpr int kChunk = kItem / NC;
#pragma unroll
  for (int i = 0; i < N; ++i) sc[i] = ds[i] = 0.f;
  fence_regs(sc);
  fence_regs(ds);
  wgmma_fence();
  start_scores<NC, false, N>(sc, q_addr, kQChunk, k_addr, kChunk);
  start_scores<NC, false, N>(ds, tq_addr, kQChunk, k_addr, kChunk);
  start_scores<NC, true, N>(ds, q_addr, kQChunk, tk_addr, kChunk);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(sc);
  fence_regs(ds);
}

// The jvp kernel: the dq kernel's tiles with TQ in place of g, and four
// walked tensors in place of two, in key tiles of kKeys = jvp_keys<NC>().
// Pass 1 forms S = Q K^T and ds = TQ K^T + Q TK^T (one accumulator chain) a
// tile and gives each row's LSE and mean dsbar = sum_j P scale ds; pass 2
// forms them again in the same order, P = exp(scale S - LSE) (masked pairs
// exactly 0) and X = P (scale ds - dsbar), and adds X V, then P TV, both
// split, into one f32 accumulator: tout.  At window 0 (and t = 0) P = 1 and
// X = 0 exactly, so tout is tv's bits.  Ring items: K_j, TK_j a tile in
// pass 1; K_j, TK_j, V_j, TV_j in pass 2.
template <int NC>
__global__ void __launch_bounds__(kThreads, 1)
swa_jvp_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_tq,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_tk,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_tv,
                    __nv_bfloat16* __restrict__ tout, int seq, int heads,
                    int kv_heads, int hd, int window, int qt, int gt,
                    int head_tiles, float scale) {
  constexpr int kSlots = jvp_slots<NC>();
  constexpr int kKeys = jvp_keys<NC>();
  constexpr int kN = kKeys / 2;                 // score registers a tile
  constexpr int kChunk = kKeys * 128;           // bytes of 64 hd columns
  constexpr int kItem = NC * kChunk;            // bytes of a walked tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* q_s = base;
  uint8_t* tq_s = q_s + NC * kQChunk;
  uint8_t* ring = tq_s + NC * kQChunk;
  uint64_t* qt_full = reinterpret_cast<uint64_t*>(ring + kSlots * kItem);
  uint64_t* full = qt_full + 1;
  uint64_t* empty = full + kSlots;

  const int group = heads / kv_heads;
  const RowTile tile(seq, group, window, qt, gt, head_tiles, kKeys);
  const int n_tiles = tile.n_tiles;

  if (threadIdx.x == 0) {
    mbar_init(qt_full, 1);
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: Q and TQ once, then the walked tiles of both passes ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(qt_full, 2 * NC * 128 * qt * gt);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        tma_load_4d(q_s + c * kQChunk, &tm_q, qt_full, c * 64, tile.h0,
                    tile.t0, tile.b);
        tma_load_4d(tq_s + c * kQChunk, &tm_tq, qt_full, c * 64, tile.h0,
                    tile.t0, tile.b);
      }
      const int items = 6 * n_tiles;
      for (int i = 0; i < items; ++i) {
        const int s = i % kSlots;
        if (i >= kSlots) mbar_wait(&empty[s], ((i / kSlots) & 1) ^ 1);
        mbar_expect_tx(&full[s], kItem);
        // pass 1: K_j, TK_j; pass 2: K_j, TK_j, V_j, TV_j
        const int p2 = i - 2 * n_tiles;
        const int j = p2 < 0 ? i >> 1 : p2 >> 2;
        const int which = p2 < 0 ? i & 1 : p2 & 3;
        const CUtensorMap* map = which == 0   ? &tm_k
                                 : which == 1 ? &tm_tk
                                 : which == 2 ? &tm_v
                                              : &tm_tv;
        const int k0 = tile.k_begin + j * kKeys;
#pragma unroll
        for (int c = 0; c < NC; ++c)
          tma_load_4d(ring + s * kItem + c * kChunk, map, &full[s], c * 64,
                      tile.kvh, k0, tile.b);
      }
    }
  } else {
    // ---- consumers: 64 rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const ThreadRows rows(tile, seq, group, qt, gt);
    const int cw = wg - 1;
    const uint32_t q_addr = smem_u32(q_s) + cw * (kQChunk / 2);
    const uint32_t tq_addr = smem_u32(tq_s) + cw * (kQChunk / 2);
    const uint32_t ring_addr = smem_u32(ring);

    mbar_wait(qt_full, 0);
    float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f}, dsum[2] = {0.f, 0.f};
    int item = 0;
    // pass 1: each row's log-sum-exp and dsbar
    for (int j = 0; j < n_tiles; ++j, item += 2) {
      const int k0 = tile.k_begin + j * kKeys;
      const int sk = item % kSlots, stk = (item + 1) % kSlots;
      mbar_wait(&full[sk], (item / kSlots) & 1);
      mbar_wait(&full[stk], ((item + 1) / kSlots) & 1);
      float sc[kN], ds[kN];
      jvp_scores<NC>(sc, ds, q_addr, tq_addr, ring_addr + sk * kItem,
                     ring_addr + stk * kItem);
      mbar_arrive(&empty[sk]);
      mbar_arrive(&empty[stk]);
#pragma unroll
      for (int i = 0; i < kN; ++i) ds[i] *= scale;
      stats_tile(sc, ds, rows.mask<kN>(k0, seq, window), m, l, dsum, scale);
    }
    float lse[2], dsbar[2];
    finish_stats(m, l, dsum, lse, dsbar);

    // pass 2: tout = sum_j X V + sum_j P TV
    float acc[NC][32];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
    for (int j = 0; j < n_tiles; ++j, item += 4) {
      const int k0 = tile.k_begin + j * kKeys;
      const int sk = item % kSlots, stk = (item + 1) % kSlots;
      const int sv = (item + 2) % kSlots, stv = (item + 3) % kSlots;
      mbar_wait(&full[sk], (item / kSlots) & 1);
      mbar_wait(&full[stk], ((item + 1) / kSlots) & 1);
      float sc[kN], ds[kN];
      jvp_scores<NC>(sc, ds, q_addr, tq_addr, ring_addr + sk * kItem,
                     ring_addr + stk * kItem);
      mbar_arrive(&empty[sk]);
      mbar_arrive(&empty[stk]);
      const uint32_t ok = rows.mask<kN>(k0, seq, window);
#pragma unroll
      for (int i = 0; i < kN; ++i) {
        const int h = (i >> 1) & 1;
        const bool v = (ok >> i) & 1u;
        const float p = v ? expf(sc[i] * scale - lse[h]) : 0.f;
        sc[i] = p;
        ds[i] = v ? p * (ds[i] * scale - dsbar[h]) : 0.f;
      }
      uint32_t hi[kN / 8][4], lo[kN / 8][4];
      split_frags(ds, hi, lo);
      mbar_wait(&full[sv], ((item + 2) / kSlots) & 1);
      add_split_product<NC>(acc, hi, lo, ring_addr + sv * kItem, kChunk);
      mbar_arrive(&empty[sv]);
      split_frags(sc, hi, lo);
      mbar_wait(&full[stv], ((item + 3) / kSlots) & 1);
      add_split_product<NC>(acc, hi, lo, ring_addr + stv * kItem, kChunk);
      mbar_arrive(&empty[stv]);
    }
    rows.store<NC>(tout, acc, tile, seq, heads, group, hd, 1.f);
  }
}

// ---- dk and dv ----------------------------------------------------------------

// Block (x, kvh, b) owns keys s0 = 64 x .. s0 + 63 of kv head kvh and walks
// tiles of 64 (query, head) rows: queries t0 .. t0 + wq - 1 x heads h0 ..
// h0 + wh - 1 of the kv group (wh = min(G, 64), wq = 64 / wh), row r being
// query r / wh and head r % wh, over t0 = s0, s0 + wq, ... <= min(s0 + 63 +
// window, T - 1), each query tile for the wht head tiles in turn
// (kernels/swa_attention.py::swa_bwd_geometry mirrors it).

// One consumer warpgroup of the dk/dv kernel over the walk: kDk adds dk +=
// dS^T q (from S^T, dP^T and D), else dv += P^T g (from S^T alone); out =
// (scale if kDk) acc.  The dv warpgroup stages each walked tile's LSE and
// D into side_s (double-buffered, [2][LSE 64 | D 64]) for both.
template <int NC, bool kDk>
__device__ __forceinline__ void dkdv_consumer(
    uint32_t k_addr, uint32_t v_addr, uint32_t q_ring, uint32_t g_ring,
    uint64_t* kv_full, uint64_t* full, uint64_t* empty, float* side_s,
    const float* __restrict__ lse_in, const float* __restrict__ d_in,
    __nv_bfloat16* __restrict__ out, int b, int kvh, int s0, int items,
    int seq, int kv_heads, int group, int hd, int window, int wq, int wh,
    int wht, int mag, float scale) {
  constexpr int kStages = dkdv_stages<NC>();
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int ct = threadIdx.x - 128;             // 0 .. 255 over both
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int quad = lane & 3;
  const int rows = wq * wh;
  int key[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) key[h] = s0 + 16 * warp + (lane >> 2) + 8 * h;
  const long long side0 = (static_cast<long long>(b) * kv_heads + kvh) * seq;

  float acc[NC][32];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;

  mbar_wait(kv_full, 0);
  for (int it = 0; it < items; ++it) {
    const int s = it % kStages;
    const int t0 = s0 + (it / wht) * wq;
    const int hb = (it % wht) * wh;             // first head in the group
    // rows 0 .. nv - 1 of the walked tile are real (query, head) pairs;
    // their LSE and D are the side output's run from side
    const int nv = wht == 1 ? min(rows, (seq - t0) * group)
                            : min(wh, group - hb);
    const long long side = (side0 + t0) * group + hb;
    float staged = 0.f;
    if (!kDk) {                  // LSE (+1e30 where no row) or D of row r
      const int r = ct & 63;
      const bool is_d = ct >= 64;
      staged = r < nv ? __ldg((is_d ? d_in : lse_in) + side + r)
                      : (is_d ? 0.f : kBig);
    }
    const uint32_t q_addr = q_ring + s * NC * kTile;
    const uint32_t g_addr = g_ring + s * NC * kTile;
    mbar_wait(&full[s], (it / kStages) & 1);

    float sc[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    fence_regs(sc);
    if constexpr (kDk) {
#pragma unroll
      for (int i = 0; i < 32; ++i) dp[i] = 0.f;
      fence_regs(dp);
    }
    wgmma_fence();
    start_scores<NC>(sc, k_addr, kTile, q_addr, kTile);      // S^T = K Q^T
    if constexpr (kDk)
      start_scores<NC>(dp, v_addr, kTile, g_addr, kTile);    // dP^T = V g^T
    wgmma_commit();
    float* lse_d = side_s + (it & 1) * 128;
    if (!kDk) lse_d[ct] = staged;
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    wgmma_wait_all();
    fence_regs(sc);
    if constexpr (kDk) fence_regs(dp);

    // every (key, query) pair of the tile inside the band?
    const bool interior = t0 >= s0 + kBK - 1 && t0 + wq - 1 - s0 <= window;
    // column col = 8 jj + 2 quad + e of the score tile is walked row col,
    // query t0 + col / wh; registers 4 jj + 2 h + e hold it for key[h]
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * jj + 2 * quad + e;
        const int t = t0 + ((col * mag) >> 16);
        const float lse = lse_d[col];
        const float dd = kDk ? lse_d[64 + col] : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * jj + 2 * h + e;
          const bool v = interior || (key[h] <= t && t - key[h] <= window);
          const float p = v ? expf(sc[i] * scale - lse) : 0.f;
          sc[i] = kDk ? p * (dp[i] - dd) : p;
        }
      }
    uint32_t hi[4][4], lo[4][4];
    split_frags(sc, hi, lo);
    // dk += dS^T q, or dv += P^T g
    add_split_product<NC>(acc, hi, lo, kDk ? q_addr : g_addr, kTile);
    mbar_arrive(&empty[s]);
  }

  const float mul = kDk ? scale : 1.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (key[h] >= seq) continue;
    __nv_bfloat16* row =
        out + ((static_cast<long long>(b) * seq + key[h]) * kv_heads + kvh) *
                  hd;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int col = 64 * c + 8 * jj + 2 * quad;
        if (col < hd)
          *reinterpret_cast<__nv_bfloat162*>(row + col) =
              __floats2bfloat162_rn(acc[c][4 * jj + 2 * h] * mul,
                                    acc[c][4 * jj + 2 * h + 1] * mul);
      }
  }
}

template <int NC>
__global__ void __launch_bounds__(kThreads, 1)
swa_dkdv_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_g,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const float* __restrict__ lse_in,
                     const float* __restrict__ d_in,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int seq, int heads,
                     int kv_heads, int hd, int window, int wq, int wh,
                     int wht, int mag, float scale) {
  constexpr int kStages = dkdv_stages<NC>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* k_s = base;
  uint8_t* v_s = k_s + NC * kTile;
  uint8_t* q_ring = v_s + NC * kTile;
  uint8_t* g_ring = q_ring + kStages * NC * kTile;
  float* side_s = reinterpret_cast<float*>(g_ring + kStages * NC * kTile);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(side_s + 2 * 128);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;

  const int group = heads / kv_heads;
  const int b = blockIdx.z;
  const int kvh = blockIdx.y;
  const int s0 = blockIdx.x * kBK;
  const int t_last = min(s0 + kBK - 1 + window, seq - 1);
  const int items = ((t_last - s0) / wq + 1) * wht;
  const int rows = wq * wh;

  // rows rows .. 63 of every Q/g buffer are never loaded: zero them once,
  // so that dv += P^T g and dk += dS^T q meet 0 x 0 there, never 0 x NaN
  {
    const int per_buf = (kBK - rows) * 8;          // 16-byte words
    const int bufs = 2 * kStages * NC;
    for (int w = threadIdx.x; w < bufs * per_buf; w += kThreads) {
      uint8_t* buf = q_ring + (w / per_buf) * kTile;
      *reinterpret_cast<uint4*>(buf + rows * 128 + (w % per_buf) * 16) =
          make_uint4(0, 0, 0, 0);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: K and V once, then the walked Q/g tiles ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_full, 2 * NC * kTile);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        tma_load_4d(k_s + c * kTile, &tm_k, kv_full, c * 64, kvh, s0, b);
        tma_load_4d(v_s + c * kTile, &tm_v, kv_full, c * 64, kvh, s0, b);
      }
      for (int i = 0; i < items; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * NC * 128 * rows);
        const int t0 = s0 + (i / wht) * wq;
        const int h0 = kvh * group + (i % wht) * wh;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          tma_load_4d(q_ring + (s * NC + c) * kTile, &tm_q, &full[s], c * 64,
                      h0, t0, b);
          tma_load_4d(g_ring + (s * NC + c) * kTile, &tm_g, &full[s], c * 64,
                      h0, t0, b);
        }
      }
    }
  } else if (wg == 1) {
    dkdv_consumer<NC, false>(smem_u32(k_s), smem_u32(v_s), smem_u32(q_ring),
                             smem_u32(g_ring), kv_full, full, empty, side_s,
                             lse_in, d_in, dv, b, kvh, s0, items, seq,
                             kv_heads, group, hd, window, wq, wh, wht, mag,
                             scale);
  } else {
    dkdv_consumer<NC, true>(smem_u32(k_s), smem_u32(v_s), smem_u32(q_ring),
                            smem_u32(g_ring), kv_full, full, empty, side_s,
                            lse_in, d_in, dk, b, kvh, s0, items, seq,
                            kv_heads, group, hd, window, wq, wh, wht, mag,
                            scale);
  }
}

// ---- host side --------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

int encode_fn(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (!cached) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return (int)err;
    if (found != cudaDriverEntryPointSuccess || !p)
      return (int)cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return 0;
}

// A (B, T, nh, hd) bf16 tensor, boxes of 64 hd columns x box_h heads x
// box_t positions, 128B swizzle, zeros out of bounds.
int encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int batch,
           int seq, int nh, int hd, int box_h, int box_t) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)nh,
                              (cuuint64_t)seq, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)nh * hd * 2,
                                 (cuuint64_t)seq * nh * hd * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)box_h, (cuuint32_t)box_t, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + (int)r;
}

// The first two tensors ((B, T, H, hd): q and g, or q and tq) in boxes of
// (box_h heads x box_t positions), the rest ((B, T, K, hd): k and v, or k,
// tk, v and tv) in boxes of (1 head x keys)
template <int N>
int encode_all(CUtensorMap (&maps)[N], const void* const (&ptrs)[N],
               int batch, int seq, int heads, int kv_heads, int hd,
               int box_h, int box_t, int keys) {
  EncodeTiled fn;
  int err = encode_fn(&fn);
  for (int i = 0; i < N && !err; ++i)
    err = i < 2 ? encode(fn, &maps[i], ptrs[i], batch, seq, heads, hd, box_h,
                         box_t)
                : encode(fn, &maps[i], ptrs[i], batch, seq, kv_heads, hd, 1,
                         keys);
  return err;
}

template <int N>
bool misaligned(const void* const (&ptrs)[N]) {
  uintptr_t any = 0;
  for (int i = 0; i < N; ++i) any |= reinterpret_cast<uintptr_t>(ptrs[i]);
  return any % 16 != 0;
}

// the dq and jvp kernels' tiles (swa_geometry) against the shape
bool bad_row_tiles(int seq, int heads, int kv_heads, int qt, int gt,
                   int head_tiles, int grid_x, int grid_y) {
  const int group = heads / kv_heads;
  return gt < 1 || gt > group || gt > kRows || qt < 1 || qt * gt > kRows ||
         head_tiles * gt < group || (head_tiles - 1) * gt >= group ||
         grid_x != (seq + qt - 1) / qt || grid_y != kv_heads * head_tiles;
}

bool bad_shape(int kv_heads, int heads, int hd, int window, int hd_pad) {
  return kv_heads <= 0 || heads % kv_heads != 0 || hd <= 0 || hd > 256 ||
         hd % 8 != 0 || window < 0 || hd_pad < hd || hd_pad - hd >= 64 ||
         (hd_pad != 64 && hd_pad != 128 && hd_pad != 256);
}

template <int NC>
int launch_dq(const CUtensorMap (&m)[4], void* dq, float* lse, float* dd,
              int grid_x, int grid_y, int batch, int seq, int heads,
              int kv_heads, int hd, int window, int qt, int gt,
              int head_tiles, float scale, cudaStream_t stream) {
  constexpr int smem = dq_smem_bytes<NC>();
  cudaError_t err = cudaFuncSetAttribute(
      swa_dq_sm90_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  swa_dq_sm90_kernel<NC><<<dim3(grid_x, grid_y, batch), kThreads, smem,
                           stream>>>(
      m[0], m[1], m[2], m[3], (__nv_bfloat16*)dq, lse, dd, seq, heads,
      kv_heads, hd, window, qt, gt, head_tiles, scale);
  return (int)cudaGetLastError();
}

template <int NC>
int launch_jvp(const void* const (&ptrs)[6], void* tout, int grid_x,
               int grid_y, int batch, int seq, int heads, int kv_heads,
               int hd, int window, int qt, int gt, int head_tiles,
               float scale, cudaStream_t stream) {
  CUtensorMap m[6];
  if (int err = encode_all(m, ptrs, batch, seq, heads, kv_heads, hd, gt, qt,
                           jvp_keys<NC>()))
    return err;
  constexpr int smem = jvp_smem_bytes<NC>();
  cudaError_t err = cudaFuncSetAttribute(
      swa_jvp_sm90_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  swa_jvp_sm90_kernel<NC><<<dim3(grid_x, grid_y, batch), kThreads, smem,
                            stream>>>(
      m[0], m[1], m[2], m[3], m[4], m[5], (__nv_bfloat16*)tout, seq, heads,
      kv_heads, hd, window, qt, gt, head_tiles, scale);
  return (int)cudaGetLastError();
}

template <int NC>
int launch_dkdv(const CUtensorMap (&m)[4], const float* lse, const float* dd,
                void* dk, void* dv, int grid_x, int batch, int seq, int heads,
                int kv_heads, int hd, int window, int wq, int wh, int wht,
                int mag, float scale, cudaStream_t stream) {
  constexpr int smem = dkdv_smem_bytes<NC>();
  cudaError_t err = cudaFuncSetAttribute(
      swa_dkdv_sm90_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  swa_dkdv_sm90_kernel<NC><<<dim3(grid_x, kv_heads, batch), kThreads, smem,
                             stream>>>(
      m[0], m[1], m[2], m[3], lse, dd, (__nv_bfloat16*)dk,
      (__nv_bfloat16*)dv, seq, heads, kv_heads, hd, window, wq, wh, wht, mag,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* swa_attention_bwd_sm90_error_string(int err) {
  static char msg[96];
  if (err >= kEncodeError) {
    snprintf(msg, sizeof msg, "cuTensorMapEncodeTiled returned CUresult %d",
             err - kEncodeError);
    return msg;
  }
  return cudaGetErrorString((cudaError_t)err);
}

// Dynamic shared memory of a launch of the dq (kernel 0), dk/dv (kernel 1)
// or jvp (kernel 2) kernel at padded head dim hd_pad (64, 128 or 256), in
// bytes.
int swa_attention_bwd_sm90_smem_bytes(int kernel, int hd_pad) {
  if (kernel == 0)
    return hd_pad == 64 ? dq_smem_bytes<1>()
           : hd_pad == 128 ? dq_smem_bytes<2>() : dq_smem_bytes<4>();
  if (kernel == 2)
    return hd_pad == 64 ? jvp_smem_bytes<1>()
           : hd_pad == 128 ? jvp_smem_bytes<2>() : jvp_smem_bytes<4>();
  return hd_pad == 64 ? dkdv_smem_bytes<1>()
         : hd_pad == 128 ? dkdv_smem_bytes<2>() : dkdv_smem_bytes<4>();
}

// The backward's first kernel: dq, and lse and dd, (B, K, T, G) f32 side
// outputs that swa_attention_dkdv_sm90_launch reads.  q, k, v, g, dq:
// bf16.  The geometry (queries and heads per tile, head tiles, padded hd,
// grid) is the forward's, kernels/swa_attention.py::swa_geometry, checked
// here against the shape.
int swa_attention_dq_sm90_launch(const void* q, const void* k, const void* v,
                                 const void* g, void* dq, void* lse, void* dd,
                                 int batch, int seq, int heads, int kv_heads,
                                 int hd, int window, int qt, int gt,
                                 int head_tiles, int hd_pad, int grid_x,
                                 int grid_y, float scale, void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0) return 0;
  if (bad_shape(kv_heads, heads, hd, window, hd_pad) ||
      bad_row_tiles(seq, heads, kv_heads, qt, gt, head_tiles, grid_x, grid_y))
    return (int)cudaErrorInvalidValue;
  const void* const ptrs[4] = {q, g, k, v};
  const void* const outs[1] = {dq};
  if (misaligned(ptrs) || misaligned(outs))
    return (int)cudaErrorMisalignedAddress;
  CUtensorMap m[4];
  if (int err = encode_all(m, ptrs, batch, seq, heads, kv_heads, hd, gt, qt,
                           kBK))
    return err;
  cudaStream_t st = (cudaStream_t)stream;
  float* l = (float*)lse;
  float* d = (float*)dd;
  if (hd_pad == 64)
    return launch_dq<1>(m, dq, l, d, grid_x, grid_y, batch, seq, heads,
                        kv_heads, hd, window, qt, gt, head_tiles, scale, st);
  if (hd_pad == 128)
    return launch_dq<2>(m, dq, l, d, grid_x, grid_y, batch, seq, heads,
                        kv_heads, hd, window, qt, gt, head_tiles, scale, st);
  return launch_dq<4>(m, dq, l, d, grid_x, grid_y, batch, seq, heads,
                      kv_heads, hd, window, qt, gt, head_tiles, scale, st);
}

// The backward's second kernel: dk and dv from the dq kernel's lse and dd
// (launched after it on the same stream).  The walk (queries and heads per
// walked tile, head tiles, the multiplier of row -> query, padded hd,
// grid) comes from kernels/swa_attention.py::swa_bwd_geometry and is
// checked here against the shape.
int swa_attention_dkdv_sm90_launch(const void* q, const void* k,
                                   const void* v, const void* g,
                                   const void* lse, const void* dd, void* dk,
                                   void* dv, int batch, int seq, int heads,
                                   int kv_heads, int hd, int window, int wq,
                                   int wh, int wht, int mag, int hd_pad,
                                   int grid_x, float scale, void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0) return 0;
  if (bad_shape(kv_heads, heads, hd, window, hd_pad))
    return (int)cudaErrorInvalidValue;
  const int group = heads / kv_heads;
  if (wh != (group < kBK ? group : kBK) || wq != kBK / wh ||
      wht != (group + wh - 1) / wh || mag != (65536 + wh - 1) / wh ||
      grid_x != (seq + kBK - 1) / kBK)
    return (int)cudaErrorInvalidValue;
  const void* const ptrs[4] = {q, g, k, v};
  const void* const outs[2] = {dk, dv};
  if (misaligned(ptrs) || misaligned(outs))
    return (int)cudaErrorMisalignedAddress;
  CUtensorMap m[4];
  if (int err = encode_all(m, ptrs, batch, seq, heads, kv_heads, hd, wh, wq,
                           kBK))
    return err;
  cudaStream_t st = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  const float* d = (const float*)dd;
  if (hd_pad == 64)
    return launch_dkdv<1>(m, l, d, dk, dv, grid_x, batch, seq, heads,
                          kv_heads, hd, window, wq, wh, wht, mag, scale, st);
  if (hd_pad == 128)
    return launch_dkdv<2>(m, l, d, dk, dv, grid_x, batch, seq, heads,
                          kv_heads, hd, window, wq, wh, wht, mag, scale, st);
  return launch_dkdv<4>(m, l, d, dk, dv, grid_x, batch, seq, heads, kv_heads,
                        hd, window, wq, wh, wht, mag, scale, st);
}

// The jvp: tout, the output's tangent for tangents (tq, tk, tv) of (q, k,
// v), all bf16.  The geometry is the dq kernel's (swa_geometry), checked
// here against the shape.
int swa_attention_jvp_sm90_launch(const void* q, const void* k, const void* v,
                                  const void* tq, const void* tk,
                                  const void* tv, void* tout, int batch,
                                  int seq, int heads, int kv_heads, int hd,
                                  int window, int qt, int gt, int head_tiles,
                                  int hd_pad, int grid_x, int grid_y,
                                  float scale, void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0) return 0;
  if (bad_shape(kv_heads, heads, hd, window, hd_pad) ||
      bad_row_tiles(seq, heads, kv_heads, qt, gt, head_tiles, grid_x, grid_y))
    return (int)cudaErrorInvalidValue;
  const void* const ptrs[6] = {q, tq, k, tk, v, tv};
  const void* const outs[1] = {tout};
  if (misaligned(ptrs) || misaligned(outs))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = (cudaStream_t)stream;
  if (hd_pad == 64)
    return launch_jvp<1>(ptrs, tout, grid_x, grid_y, batch, seq, heads,
                         kv_heads, hd, window, qt, gt, head_tiles, scale, st);
  if (hd_pad == 128)
    return launch_jvp<2>(ptrs, tout, grid_x, grid_y, batch, seq, heads,
                         kv_heads, hd, window, qt, gt, head_tiles, scale, st);
  return launch_jvp<4>(ptrs, tout, grid_x, grid_y, batch, seq, heads,
                       kv_heads, hd, window, qt, gt, head_tiles, scale, st);
}

}  // extern "C"
