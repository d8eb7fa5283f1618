// Sliding-window causal attention forward for Hopper (sm_90a), bf16
// storage, on the tensor cores: wgmma for Q.K^T and P.V, TMA loads into a
// ring of K/V tiles, one producer warpgroup and two consumer warpgroups.
//
// q: (B, T, H, hd), k/v: (B, T, K, hd), o: (B, T, H, hd), all contiguous
// bf16, hd a multiple of 8 (TMA's 16-byte strides) and <= 256.  Query t
// attends to the keys t - window ... t (window + 1 keys, clipped at 0);
// scores are q.k in f32, multiplied by the scale in f32; softmax in f32;
// P.V with P at f32 accuracy; the output rounded to bf16 (nearest even).
// Query head h reads kv head h / (H / K): MQA/GQA K/V are never repeated.
//
// Replaces the Pallas TPU kernel src/repro/kernels/swa_attention.py:79
// swa_attention (body _swa_kernel :36) for bf16 inputs; f32 inputs keep
// the CUDA-core kernel swa_attention.cu, which does the f32 arithmetic
// exactly (the tensor cores would round f32 inputs).
//
// What bounds it on this card: operations.  At the prefill shape of
// recurrentgemma-9b (B = 2, T = 32768, H = 16, K = 1, hd = 256, window
// 2048) the useful work is 4 B H hd sum_t (min(t, window) + 1) = 2.13
// TFLOP against 1.14 GB of q, k, v and o: 2.155 ms of bf16 tensor-core
// work at 989 TFLOP/s against 0.34 ms of traffic at 3.35 TB/s.  The
// design puts all of it on the tensor cores:
//   * a tile is 128 (query, head) rows: with G = H / K query heads per kv
//     head, 128 / G consecutive queries x the G heads that read one kv
//     head (8 queries x 16 heads for recurrentgemma-9b), so each K/V tile
//     is fetched once for all G heads, and the key span of a tile is
//     window + 128 / G.  G = 1 gives 128 queries of one head; a G that
//     does not divide 128 takes floor(128 / G) queries and masks the rows
//     left over; G > 128 tiles the heads (128 a tile).  The mapping, the
//     grid and each tile's key range are computed on the host by
//     kernels/swa_attention.py::swa_geometry and mirrored here;
//   * Q (one 4-D TMA box per 64 columns of hd) is loaded once; a producer
//     warpgroup keeps a 2-stage ring of (K, V) tiles of 64 keys in flight
//     with TMA, completion on mbarriers; zero fill past T and past hd
//     comes from TMA's out-of-bounds fill (hd is padded to 64, 128 or
//     256), and the ragged edges are masked here.  128B swizzle, so the
//     tiles feed wgmma without bank conflicts;
//   * two consumer warpgroups, 64 rows each: S = Q.K^T with wgmma
//     m64n64k16 (bf16 x bf16 -> f32; the products are exact, only the
//     order of the sums differs from the plain version), then the scale,
//     the mask and an online softmax in f32 in registers (expf; a masked
//     score gets probability 0 explicitly, so a row that has seen no
//     valid key keeps l = 0 and acc = 0);
//   * O += P.V at f32 accuracy on the tensor cores: P is split as
//     P_hi = bf16(P) and P_lo = bf16(P - P_hi), and two wgmma with A from
//     registers (the P fragments) and B the V tile from shared memory
//     (transposed, which 16-bit types allow) add both into the f32
//     accumulator.  V is bf16, so both products are exact; the split's
//     error is at most about 2^-17 |p|, far below one bf16 ulp of the
//     output.  1.5x the useful FLOPs, and the reference's f32 P.V kept;
//   * setmaxnreg gives the consumers 240 registers (O is 128 of them at
//     hd 256) and the producer 24;
//   * no atomics and a fixed order of every sum, so two launches on the
//     same inputs give the same bits.
//
// Shared memory at hd 256: Q 64 KB, K and V 2 x 2 x 32 KB: 192 KB, one
// block of 384 threads per SM.  The tensor maps are encoded on the host
// for each launch (cuTensorMapEncodeTiled, looked up at run time through
// the CUDA runtime, so the library needs no -lcuda) and passed as
// __grid_constant__ parameters.  The kernel allocates nothing and
// launches on the stream it is given.  Plain C interface (ctypes); the
// launcher returns cudaGetLastError(), or a code >= kEncodeError when a
// tensor map could not be encoded.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

namespace {

constexpr int kRows = 128;             // (query, head) rows of a tile
constexpr int kBK = 64;                // keys per K/V tile
constexpr int kStages = 2;             // K/V ring depth
constexpr int kThreads = 384;          // producer + 2 consumer warpgroups
constexpr int kQChunk = kRows * 128;   // bytes of 128 rows x 64 bf16
constexpr int kKVChunk = kBK * 128;    // bytes of 64 keys x 64 bf16
constexpr float kNeg = -1e30f;
constexpr int kEncodeError = 100000;   // + CUresult of a failed encode

template <int NC>
constexpr int smem_bytes() {
  return 1024 /* alignment slack */ + NC * kQChunk
         + 2 * kStages * NC * kKVChunk + (1 + 2 * kStages) * 8;
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

// K-major operand (Q rows or K rows, 128 bytes = 64 bf16 of hd each,
// 8-row groups 1024 bytes apart); the 16-wide k step inside the 128-byte
// swizzle atom moves the start address by 32 bytes.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return sw128_desc(addr, 16, 1024);
}

// MN-major operand (the V tile: 64 keys x 64 hd columns, each key row 128
// bytes): one 64-column swizzle atom across N, 8-key groups 1024 bytes
// apart along K; a 16-key k step moves the start address by 2048 bytes.
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

// Keeps the compiler from reading or moving accumulator registers across
// the asynchronous wgmma (they are final only after wgmma_wait_all).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
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

// ---- the online softmax of one 64 x 64 score tile --------------------------
//
// Accumulator layout of wgmma m64n64 (f32), per thread of a warpgroup:
// register i holds row 16 * warp + lane / 4 + 8 * ((i >> 1) & 1), column
// 8 * (i >> 2) + 2 * (lane % 4) + (i & 1).  A row's 64 scores are spread
// over the 4 lanes of a quad, 16 each.
template <bool kMasked>
__device__ __forceinline__ void softmax_tile(float (&sc)[32], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             const int (&trow)[2],
                                             const bool (&rvalid)[2], int k0,
                                             int quad, int seq, int window,
                                             float scale) {
  uint32_t ok = 0xffffffffu;
  if (kMasked) {
    ok = 0;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      const int kpos = k0 + 8 * (i >> 2) + 2 * quad + (i & 1);
      const bool v = rvalid[h] && kpos <= trow[h] &&
                     kpos >= trow[h] - window && kpos < seq;
      ok |= static_cast<uint32_t>(v) << i;
    }
  }
  float mt[2] = {kNeg, kNeg};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int h = (i >> 1) & 1;
    sc[i] = ((ok >> i) & 1u) ? sc[i] * scale : kNeg;
    mt[h] = fmaxf(mt[h], sc[i]);
  }
  float mn[2], ls[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 1));
    mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 2));
    mn[h] = fmaxf(m[h], mt[h]);
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int h = (i >> 1) & 1;
    sc[i] = ((ok >> i) & 1u) ? expf(sc[i] - mn[h]) : 0.f;
    ls[h] += sc[i];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    ls[h] += __shfl_xor_sync(0xffffffffu, ls[h], 1);
    ls[h] += __shfl_xor_sync(0xffffffffu, ls[h], 2);
    corr[h] = expf(m[h] - mn[h]);      // 1 while the row saw no valid key
    l[h] = l[h] * corr[h] + ls[h];
    m[h] = mn[h];
  }
}

template <int NC>
__global__ void __launch_bounds__(kThreads, 1)
swa_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                __nv_bfloat16* __restrict__ o, int seq, int heads, int group,
                int hd, int window, int qt, int gt, int head_tiles,
                float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* q_s = base;
  uint8_t* k_s = q_s + NC * kQChunk;
  uint8_t* v_s = k_s + kStages * NC * kKVChunk;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(v_s + kStages * NC * kKVChunk);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  // the tile: queries t0 .. t0 + qt - 1 x heads h0 .. h0 + gt - 1 of kv
  // head kvh in batch row b; its keys k_begin .. k_end - 1 in n_tiles
  // tiles of kBK (swa_geometry's key_span)
  const int b = blockIdx.z;
  const int kvh = blockIdx.y / head_tiles;
  const int ht = blockIdx.y % head_tiles;
  const int t0 = blockIdx.x * qt;
  const int h0 = kvh * group + ht * gt;
  const int k_begin = max(0, t0 - window);
  const int k_end = min(t0 + qt, seq);
  const int n_tiles = (k_end - k_begin + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * 128);   // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: Q once, then the K/V ring ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, NC * 128 * qt * gt);
#pragma unroll
      for (int c = 0; c < NC; ++c)
        tma_load_4d(q_s + c * kQChunk, &tm_q, q_full, c * 64, h0, t0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * NC * kKVChunk);
        const int k0 = k_begin + j * kBK;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          tma_load_4d(k_s + (s * NC + c) * kKVChunk, &tm_k, &full[s], c * 64,
                      kvh, k0, b);
          tma_load_4d(v_s + (s * NC + c) * kKVChunk, &tm_v, &full[s], c * 64,
                      kvh, k0, b);
        }
      }
    }
  } else {
    // ---- consumers: 64 rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = wg - 1;
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int quad = lane & 3;
    int trow[2], ohead[2];
    bool rvalid[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 64 * cw + 16 * warp + (lane >> 2) + 8 * h;
      const int tq = r / gt, gi = r % gt;
      trow[h] = t0 + tq;
      ohead[h] = h0 + gi;
      rvalid[h] = tq < qt && trow[h] < seq && ht * gt + gi < group;
    }
    // every row of the tile is a real (query, head) pair
    const bool full_rows =
        qt * gt == kRows && t0 + qt <= seq && ht * gt + gt <= group;
    const int t_lo = t0, t_hi = k_end - 1;

    float acc[NC][32];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
    float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};

    const uint32_t q_addr = smem_u32(q_s) + cw * (kQChunk / 2);
    mbar_wait(q_full, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages;
      const int k0 = k_begin + j * kBK;
      const uint32_t k_addr = smem_u32(k_s) + s * NC * kKVChunk;
      const uint32_t v_addr = smem_u32(v_s) + s * NC * kKVChunk;
      mbar_wait(&full[s], (j / kStages) & 1);

      // S = Q . K^T over hd, 16 at a time
      float sc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss(sc, kmajor_desc(q_addr + c * kQChunk + kk * 32),
                   kmajor_desc(k_addr + c * kKVChunk + kk * 32),
                   (c | kk) != 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      float corr[2];
      const bool interior = full_rows && k0 >= t_hi - window &&
                            k0 + kBK - 1 <= t_lo;
      if (interior)
        softmax_tile<false>(sc, m, l, corr, trow, rvalid, k0, quad, seq,
                            window, scale);
      else
        softmax_tile<true>(sc, m, l, corr, trow, rvalid, k0, quad, seq,
                           window, scale);

      // P = P_hi + P_lo as A fragments of m64n64k16 (16 keys a step):
      // a0 = (row, keys 2q, 2q+1), a1 = (row + 8, same), a2 = (row, keys
      // 2q + 8, 2q + 9), a3 = (row + 8, same): registers 8kk .. 8kk + 7
      uint32_t p_hi[4][4], p_lo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x0 = sc[8 * kk + 2 * e], x1 = sc[8 * kk + 2 * e + 1];
          const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
          const float2 hf = __bfloat1622float2(hi);
          p_hi[kk][e] = bf16x2_bits(hi);
          p_lo[kk][e] = bf16x2_bits(__floats2bfloat162_rn(x0 - hf.x,
                                                          x1 - hf.y));
        }
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[c][i] *= corr[(i >> 1) & 1];

      // O += P_hi . V + P_lo . V
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const uint64_t dv = mnmajor_desc(v_addr + c * kKVChunk + kk * 2048);
          wgmma_rs(acc[c], p_hi[kk], dv);
          wgmma_rs(acc[c], p_lo[kk], dv);
        }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int c = 0; c < NC; ++c) fence_regs(acc[c]);
      mbar_arrive(&empty[s]);            // this thread is done with stage s
    }

    // o = acc / l, rounded to bf16; two adjacent columns a store
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!rvalid[h]) continue;
      const float den = fmaxf(l[h], 1e-30f);
      __nv_bfloat16* orow =
          o + ((static_cast<long long>(b) * seq + trow[h]) * heads +
               ohead[h]) * hd;
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int col = 64 * c + 8 * jj + 2 * quad;
          if (col < hd)
            *reinterpret_cast<__nv_bfloat162*>(orow + col) =
                __floats2bfloat162_rn(acc[c][4 * jj + 2 * h] / den,
                                      acc[c][4 * jj + 2 * h + 1] / den);
        }
    }
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

template <int NC>
int launch(const CUtensorMap& mq, const CUtensorMap& mk,
           const CUtensorMap& mv, void* o, int grid_x, int grid_y, int batch,
           int seq, int heads, int group, int hd, int window, int qt, int gt,
           int head_tiles, float scale, cudaStream_t stream) {
  constexpr int smem = smem_bytes<NC>();
  cudaError_t err = cudaFuncSetAttribute(
      swa_sm90_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(grid_x, grid_y, batch);
  swa_sm90_kernel<NC><<<grid, kThreads, smem, stream>>>(
      mq, mk, mv, (__nv_bfloat16*)o, seq, heads, group, hd, window, qt, gt,
      head_tiles, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* swa_attention_sm90_error_string(int err) {
  static char msg[96];
  if (err >= kEncodeError) {
    snprintf(msg, sizeof msg, "cuTensorMapEncodeTiled returned CUresult %d",
             err - kEncodeError);
    return msg;
  }
  return cudaGetErrorString((cudaError_t)err);
}

// Dynamic shared memory of a launch at padded head dim hd_pad (64, 128
// or 256), in bytes.
int swa_attention_sm90_smem_bytes(int hd_pad) {
  return hd_pad == 64 ? smem_bytes<1>()
         : hd_pad == 128 ? smem_bytes<2>() : smem_bytes<4>();
}

// q, k, v, o: bf16.  The geometry (queries and heads per tile, head tiles,
// padded hd, grid) comes from kernels/swa_attention.py::swa_geometry and
// is checked here against the shape.
int swa_attention_sm90_launch(const void* q, const void* k, const void* v,
                              void* o, int batch, int seq, int heads,
                              int kv_heads, int hd, int window, int qt,
                              int gt, int head_tiles, int hd_pad, int grid_x,
                              int grid_y, float scale, void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0) return 0;
  if (kv_heads <= 0 || heads % kv_heads != 0 || hd <= 0 || hd > 256 ||
      hd % 8 != 0 || window < 0)
    return (int)cudaErrorInvalidValue;
  const int group = heads / kv_heads;
  if (gt < 1 || gt > group || gt > kRows || qt < 1 || qt * gt > kRows ||
      head_tiles * gt < group || (head_tiles - 1) * gt >= group ||
      grid_x != (seq + qt - 1) / qt || grid_y != kv_heads * head_tiles ||
      hd_pad < hd || hd_pad - hd >= 64 ||
      (hd_pad != 64 && hd_pad != 128 && hd_pad != 256))
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) % 16)
    return (int)cudaErrorMisalignedAddress;
  EncodeTiled fn;
  int err = encode_fn(&fn);
  if (err) return err;
  CUtensorMap mq, mk, mv;
  if ((err = encode(fn, &mq, q, batch, seq, heads, hd, gt, qt))) return err;
  if ((err = encode(fn, &mk, k, batch, seq, kv_heads, hd, 1, kBK))) return err;
  if ((err = encode(fn, &mv, v, batch, seq, kv_heads, hd, 1, kBK))) return err;
  cudaStream_t st = (cudaStream_t)stream;
  if (hd_pad == 64)
    return launch<1>(mq, mk, mv, o, grid_x, grid_y, batch, seq, heads, group,
                     hd, window, qt, gt, head_tiles, scale, st);
  if (hd_pad == 128)
    return launch<2>(mq, mk, mv, o, grid_x, grid_y, batch, seq, heads, group,
                     hd, window, qt, gt, head_tiles, scale, st);
  return launch<4>(mq, mk, mv, o, grid_x, grid_y, batch, seq, heads, group,
                   hd, window, qt, gt, head_tiles, scale, st);
}

}  // extern "C"
