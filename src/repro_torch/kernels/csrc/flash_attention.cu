// Kernel B4: blockwise online-softmax (flash) attention in float32, with
// GQA, causal and sliding-window masks, gemma2's logit soft-cap and query
// positions aligned to the end of the kv axis, for sm_90a.
//
// Replaces repro/kernels/flash_attention.py: flash_attention_pallas
// (kernel _flash_kernel), vmapped over batch and heads by
// repro/kernels/ops.py: flash_attention.  For batch b, query head h (KV
// head h / G, G = H / KV) and query row i at key position p = i + T - S:
//   s_t = (sum_d q[b, i, h, d] * k[b, t, h/G, d]) * scale
//   s_t = softcap * tanh(s_t / softcap)                (when softcap > 0)
//   out[b, i, h, :] = sum_t softmax(s)_t * v[b, t, h/G, :]
// over the keys t with t <= p (causal) and t > p - window (window > 0).
// A row with no valid key writes 0, as the reference's dense oracle
// (ref.mha_ref) does.  The Pallas kernel does not: it masks with -1e30,
// so exp(s - m) is 1 for every masked key of such a row.  Only a query
// row that precedes every key (S > T, causal) is such a row, and no
// self-attention path makes one.
//
// Bound on the H100: operations.  At the prefill shapes (S = T = 8192, D
// 80 or 256) each unmasked (query, key) pair costs 4 * D flops against
// 8 * D bytes of K and V that every query tile shares.  Float32 on the
// FMA pipes peaks at 67 TFLOP/s; the TF32 tensor cores at 495.  TF32
// keeps 10 mantissa bits, too few for the 1e-5 contract with the dense
// oracle, so both products run in 3xTF32: each float32 operand a is split
// into big = tf32(a) (cvt.rna) and small = a - big (exact; the tensor
// cores keep its top 11 bits), and a.b is taken as big.big + big.small +
// small.big, which drops only the small.small term and small's low bits
// (about 2^-22 of |a||b| each).  That is three
// times the tensor-core work, a bound of 3 * 4 * D * pairs / 495 TFLOP/s,
// still 5.4x below the FMA bound.  Measured on the H100 the kernel runs
// at about a third of that bound at the danube prefill, and no one part
// binds it (tools/kernel_ablation.py): taking out the producer's stores,
// its loads, S's products, P.V's products or the softmax's expf each
// shortens it by 6-17%, since they share the SM's issue slots and shared
// memory.
//
// Design.  A block holds NWG consumer warpgroups of 64 query rows each
// and one producer warpgroup:
//  * the producer stages BK keys at a time into a ring of STAGES stages,
//    each guarded by a "full" and an "empty" mbarrier, keeping the next
//    tile's loads in registers while it stores the current one.  The
//    split into big and small, and the transpose of V (the P.V product's
//    B operand must be key-major, which a TMA copy cannot give), are done
//    in its registers on the way, so it uses plain loads, not TMA.  Both
//    operands land in the no-swizzle core-matrix layout (8 rows x 16
//    bytes per core matrix, the 16-byte chunks of all rows one after the
//    other), K as (key, d), V as (d, key).  (The 128-byte swizzled layout
//    was tried on the H100: as fast, and its padding of D to whole
//    128-byte atoms cost the D 80 block its third stage);
//  * each consumer warpgroup runs S = Q.K^T as wgmma.mma_async
//    m64nBKk8.f32.tf32.tf32 (Q's fragments as below), the online
//    softmax in float32 on the accumulator fragment, then O += P.V with
//    P from registers.  The accumulator
//    fragment of S holds keys 2c, 2c + 1 of each 8-key group where the A
//    fragment wants keys c, c + 4, so the producer stores V's keys of each
//    group in the order 0 2 4 6 1 3 5 7 and P goes to the second product
//    without a shuffle;
//  * query rows are (query, head of the KV group) pairs, query-major, so
//    one tile serves the G query heads that share a KV head: K and V are
//    read once for all of them, and a short S (decode, the end-aligned
//    row) still fills a 64-row tile;
//  * key tiles wholly outside the causal / window band of a block are
//    never loaded, and a warpgroup skips the products of a tile outside
//    its own rows' band;
//  * where the (query tile, KV head, batch) blocks cannot fill the card
//    (plan() in kernels/flash_attention.py), the key axis is split over
//    a thread block cluster of CS blocks: each keeps its partial (m, l,
//    O), and after a cluster barrier each block merges a 1/CS share of
//    the rows from every block's shared memory (DSMEM), in rank order,
//    in the same launch.
// Two shapes of block: for D <= 80 (head dim padded to 16, 32, 48, 64
// or 80) two consumer warpgroups (128 rows), 32-key stages, 3 stages, and
// Q's big and small halves in shared memory as the A operand of S's
// three products; for D up to 256 (padded to 256) one consumer
// warpgroup, 16-key stages, 2 stages, Q in shared memory split four
// k-steps at a time into registers, and P.V in four 64-wide products.
//
// The tensor cores' float32 sums round with a bias (toward zero, as
// published for earlier NVIDIA tensor cores), so an accumulator that
// collects the whole key axis drifts: O summed in one accumulator over
// the 128 tiles of the danube prefill missed 1e-5 by 5x on the H100.  So
// each tile's P.V goes to a fresh accumulator and is added to O with one
// rounding (O = fmaf(O, alpha, P.V)), and in both products the small
// terms are summed first, so that the bias grows with big.big's few
// steps alone (10 at D 80; at D 256 four-step chunks are added with
// round-to-nearest).
//
// Numerics: the statistics and the softmax in float32 as before: expf
// (not __expf), tanhf, correctly rounded division; the library is built
// with -fmad=false.  The result matches the dense plain version within
// 1e-5, not bitwise: the sums run in another order and 3xTF32 drops the
// small.small term.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_D = 256;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(
          smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// generic-proxy shared stores made visible to wgmma's async proxy
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// float at shared address `addr` of block `rank` of the cluster
__device__ __forceinline__ float ld_cluster(uint32_t addr, uint32_t rank) {
  uint32_t remote;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(addr), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v)
               : "r"(remote)
               : "memory");
  return v;
}

// wgmma shared-memory matrix descriptor, no swizzle: start address, the
// byte stride between core matrices along K (leading byte offset) and
// along M / N (stride byte offset)
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
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

// Keeps the compiler from reading an accumulator before the wgmma that
// writes it has been waited for, and from reusing an A operand's
// registers while a wgmma may still read them.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// round to nearest (ties away) to tf32, low 13 bits zero
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// a = big + small: big = tf32(a); small = a - big is exact, and the
// tensor cores keep its top 11 bits (about 2^-22 of |a|)
__device__ __forceinline__ void split(float a, uint32_t& big,
                                      uint32_t& small) {
  big = tf32(a);
  small = __float_as_uint(__fsub_rn(a, __uint_as_float(big)));
}

// wgmma.mma_async m64nNk8 f32 (+)= tf32 (A: 4 registers) x tf32 (B: shared
// memory, K-major), one function per N; acc 0 starts the sum afresh
__device__ __forceinline__ void wgmma_n16(float (&d)[8],
                                          const uint32_t (&a)[4],
                                          uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_n32(float (&d)[16],
                                          const uint32_t (&a)[4],
                                          uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_n48(float (&d)[24],
                                          const uint32_t (&a)[4],
                                          uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, {%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_n64(float (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_n80(float (&d)[40],
                                          const uint32_t (&a)[4],
                                          uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// the same with A from shared memory (Q's small half), N = 32
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                             uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db, int acc) {
  if constexpr (N == 16) wgmma_n16(d, a, db, acc);
  else if constexpr (N == 32) wgmma_n32(d, a, db, acc);
  else if constexpr (N == 48) wgmma_n48(d, a, db, acc);
  else if constexpr (N == 64) wgmma_n64(d, a, db, acc);
  else wgmma_n80(d, a, db, acc);
}

// The block shape for a padded head dim DP.  D <= 80: NWG = 2 consumer
// warpgroups, 32-key stages, Q's big and small halves in shared memory as
// wgmma A operands.  D <= 256: one consumer warpgroup, 16-key stages, Q
// in shared memory whole and split QCH k-steps at a time into registers,
// P.V in 64-wide products.
template <int DP_>
struct Shape {
  static constexpr int DP = DP_;
  static constexpr bool WIDE = DP > 80;
  static constexpr int NWG = WIDE ? 1 : 2;
  static constexpr int BK = WIDE ? 16 : 32;
  static constexpr int STAGES = WIDE ? 2 : 3;
  static constexpr int NW = WIDE ? 64 : DP;
  static constexpr int QCH = WIDE ? 4 : DP / 8;
  static constexpr int BQ = 64 * NWG;
  static constexpr int THREADS = 128 * (NWG + 1);
  static constexpr int KS = DP / 8;              // k-steps of Q.K^T
  static constexpr int NB = DP / NW;
  static constexpr int TILE = BK * DP;           // floats of one operand
  static constexpr int QROW = DP + 4;            // WIDE: Q's row stride
  static constexpr int K_PER = BK * DP / 4 / 128;  // producer float4s
  static constexpr int V_PER = BK * DP / 4 / 128;  // producer 4-key units
  // shared memory: the ring (K big, K small, V big, V small per stage),
  // Q (raw when WIDE, else its big and small halves), m and l of every
  // row, the barriers
  static constexpr int RING = STAGES * 4 * TILE;
  static constexpr int QFLOATS = WIDE ? BQ * QROW : 2 * BQ * DP;
  static constexpr int BYTES = 4 * (RING + QFLOATS + 2 * BQ) + 16 * STAGES;
  static_assert(DP % 16 == 0 && DP % NW == 0 && KS % QCH == 0, "shape");
  static_assert((BK * DP / 4) % 128 == 0, "producer units");
  static_assert(BQ * DP <= RING, "the partials fit in the ring");
  static_assert(BYTES <= 232448, "one block's shared memory");
};

struct Args {
  const float* q;
  const float* k;
  const float* v;
  float* out;
  int S, T, H, KV, D, causal, window;
  float softcap, scale;
  int cs, n_tiles, vec;
  int off;         // query row i sits at key position i + off
};

// What one producer thread holds of a stage between its loads and its
// stores: float4 chunks of K rows, and 4 keys of one V column.
template <class SH>
struct Staged {
  float4 k[SH::K_PER];
  float v[SH::V_PER][4];
};

template <class SH>
struct Producer {
  const float* kb;   // K of this (batch, KV head); row stride kv_row
  const float* vb;
  size_t kv_row;
  int T, D, vec, pt;

  // K unit u: 32 units = 8 rows x 4 chunks, so that 8 neighbouring lanes
  // store 8 rows of one chunk (128 contiguous bytes)
  __device__ void k_unit(int u, int& n, int& c) const {
    constexpr int RB = SH::BK / 8;
    const int l = u & 31, grp = u >> 5;
    n = 8 * (grp % RB) + (l & 7);
    c = 4 * (grp / RB) + (l >> 3);
  }

  __device__ void load(int j0, Staged<SH>& s) const {
#pragma unroll
    for (int i = 0; i < SH::K_PER; ++i) {
      int n, c;
      k_unit(pt + 128 * i, n, c);
      const int t = j0 + n, d = 4 * c;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t < T) {
        const float* src = kb + t * kv_row + d;
        if (vec) {
          if (d < D) x = *reinterpret_cast<const float4*>(src);
        } else {
          if (d < D) x.x = src[0];
          if (d + 1 < D) x.y = src[1];
          if (d + 2 < D) x.z = src[2];
          if (d + 3 < D) x.w = src[3];
        }
      }
      s.k[i] = x;
    }
#pragma unroll
    for (int i = 0; i < SH::V_PER; ++i) {
      const int u = pt + 128 * i;
      const int d = u % SH::DP, q2 = u / SH::DP;
      const int t0 = j0 + 8 * (q2 >> 1) + (q2 & 1);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int t = t0 + 2 * m;
        s.v[i][m] = (t < T && d < D) ? vb[t * kv_row + d] : 0.0f;
      }
    }
  }

  // K as (key, d) and V as (d, key) core matrices, each split in two
  __device__ void store(const Staged<SH>& s, float* stage) const {
    float* kbig = stage;
    float* ksml = stage + SH::TILE;
    float* vbig = stage + 2 * SH::TILE;
    float* vsml = stage + 3 * SH::TILE;
#pragma unroll
    for (int i = 0; i < SH::K_PER; ++i) {
      int n, c;
      k_unit(pt + 128 * i, n, c);
      const int o = c * (SH::BK * 4) + n * 4;
      uint4 big, sml;
      split(s.k[i].x, big.x, sml.x);
      split(s.k[i].y, big.y, sml.y);
      split(s.k[i].z, big.z, sml.z);
      split(s.k[i].w, big.w, sml.w);
      *reinterpret_cast<uint4*>(kbig + o) = big;
      *reinterpret_cast<uint4*>(ksml + o) = sml;
    }
#pragma unroll
    for (int i = 0; i < SH::V_PER; ++i) {
      const int u = pt + 128 * i;
      const int d = u % SH::DP, q2 = u / SH::DP;
      // chunk 2j holds keys 8j + 0, 2, 4, 6; chunk 2j + 1 keys 1, 3, 5, 7
      const int o = q2 * (SH::DP * 4) + d * 4;
      uint4 big, sml;
      split(s.v[i][0], big.x, sml.x);
      split(s.v[i][1], big.y, sml.y);
      split(s.v[i][2], big.z, sml.z);
      split(s.v[i][3], big.w, sml.w);
      *reinterpret_cast<uint4*>(vbig + o) = big;
      *reinterpret_cast<uint4*>(vsml + o) = sml;
    }
  }
};

template <class SH>
__global__ void __launch_bounds__(SH::THREADS, 1)
flash_attention_kernel(const Args a) {
  constexpr int BQ = SH::BQ, BK = SH::BK, DP = SH::DP, NW = SH::NW;
  constexpr int NB = SH::NB, KS = SH::KS, QCH = SH::QCH;
  constexpr int STAGES = SH::STAGES, TILE = SH::TILE;
  extern __shared__ __align__(128) unsigned char smem[];
  float* const ring = reinterpret_cast<float*>(smem);
  float* const qsm = ring + SH::RING;
  float* const m_sm = qsm + SH::QFLOATS;
  float* const l_sm = m_sm + BQ;
  uint64_t* const full = reinterpret_cast<uint64_t*>(l_sm + BQ);
  uint64_t* const empty = full + STAGES;

  const int tid = threadIdx.x;
  const int cs = a.cs;
  const uint32_t rank = cs > 1 ? cluster_rank() : 0;
  const int tile = a.n_tiles - 1 - static_cast<int>(blockIdx.x) / cs;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int S = a.S, T = a.T, H = a.H, D = a.D;
  const int G = H / a.KV;
  const int RV = S * G;          // rows of this KV head: (query, head)
  const int v0 = tile * BQ;
  const int off = a.off;
  const int causal = a.causal, window = a.window;

  // the key tiles some row of this block can see, and this block's share
  const int v_last = min(v0 + BQ, RV) - 1;
  const int p_lo = v0 / G + off, p_hi = v_last / G + off;
  const int k_hi = causal ? min(T - 1, p_hi) : T - 1;
  const int k_lo = window > 0 ? max(0, p_lo - window + 1) : 0;
  const int kt0 = k_hi >= k_lo ? k_lo / BK : 0;
  const int n_kt = k_hi >= k_lo ? k_hi / BK - kt0 + 1 : 0;
  const int kbeg = kt0 + static_cast<int>(rank) * n_kt / cs;
  const int nk = kt0 + (static_cast<int>(rank) + 1) * n_kt / cs - kbeg;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 128);
      mbar_init(&empty[s], 128 * SH::NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const size_t q_row = static_cast<size_t>(H) * D;
  const size_t kv_row = static_cast<size_t>(a.KV) * D;
  const int wg = tid >> 7;

  // the consumer's rows: r0 = 16 warp + lane / 4 and r0 + 8 of its
  // warpgroup's 64; rloc is r0 in the block's tile
  const int lt = tid & 127, warp = lt >> 5, lane = tid & 31;
  const int g8 = lane >> 2, c4 = lane & 3;
  const int rloc = 64 * wg + 16 * warp + g8;
  int pos[2];
  bool valid[2];
  size_t row_off[2];   // offset of (b, query, head) in q and out
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int vr = v0 + rloc + 8 * ri;
    valid[ri] = vr < RV;
    const int i = valid[ri] ? vr / G : 0;
    pos[ri] = i + off;
    row_off[ri] = (static_cast<size_t>(b) * S + i) * q_row +
                  static_cast<size_t>(kvh * G + (valid[ri] ? vr % G : 0)) * D;
  }
  float o[NB][NW / 2];
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.0f, 0.0f};
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int x = 0; x < NW / 2; ++x) o[nb][x] = 0.0f;

  if (wg == SH::NWG) {
    // ---- producer: the ring, one stage of loads ahead -------------------
    const size_t kv_base =
        static_cast<size_t>(b) * T * kv_row + static_cast<size_t>(kvh) * D;
    Producer<SH> p{a.k + kv_base, a.v + kv_base, kv_row, T, D, a.vec,
                   tid - 128 * SH::NWG};
    Staged<SH> cur, nxt;
    if (nk > 0) p.load(kbeg * BK, cur);
    for (int it = 0; it < nk; ++it) {
      const int s = it % STAGES;
      if (it + 1 < nk) p.load((kbeg + it + 1) * BK, nxt);
      if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) - 1) & 1);
      p.store(cur, ring + s * 4 * TILE);
      fence_async_shared();
      mbar_arrive(&full[s]);
      cur = nxt;
    }
  } else {
    // ---- consumers --------------------------------------------------------
    // this warpgroup's rows and the keys they can see
    const int wv_lo = v0 + 64 * wg;
    const int wv_hi = min(wv_lo + 63, RV - 1);
    const bool has_rows = wv_lo < RV;
    const int wp_lo = wv_lo / G + off, wp_hi = wv_hi / G + off;
    const int wk_hi = causal ? min(T - 1, wp_hi) : T - 1;
    const int wk_lo = window > 0 ? max(0, wp_lo - window + 1) : 0;

    // Q as the A operand of S: WIDE, raw rows, split into registers QCH
    // k-steps at a time (fragment m64k8 tf32: [0] row r0, d = 8 ks + c4;
    // [1] row r0 + 8; [2], [3] the same rows at d + 4); otherwise its big
    // and small halves in the core-matrix layout (chunk of 4 d, then row)
    uint32_t qb[SH::WIDE ? QCH : 1][4], qs[SH::WIDE ? QCH : 1][4];
    uint32_t* const qbig = reinterpret_cast<uint32_t*>(qsm);
    uint32_t* const qsml = qbig + BQ * DP;
    for (int idx = lt; idx < 64 * DP; idx += 128) {
      const int r = idx / DP, d = idx - r * DP;
      const int vr = wv_lo + r;
      float x = 0.0f;
      if (vr < RV && d < D)
        x = a.q[(static_cast<size_t>(b) * S + vr / G) * q_row +
                static_cast<size_t>(kvh * G + vr % G) * D + d];
      if constexpr (SH::WIDE) {
        qsm[(64 * wg + r) * SH::QROW + d] = x;
      } else {
        const int o = (d >> 2) * BQ * 4 + (64 * wg + r) * 4 + (d & 3);
        split(x, qbig[o], qsml[o]);
      }
    }
    if constexpr (!SH::WIDE) fence_async_shared();
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");

    // The accumulators of S and of one tile's P.V, carried from tile to
    // tile (each tile's first product starts them afresh), so that every
    // wgmma's registers hold defined values: with undefined inputs, the
    // register allocator may give an in-flight accumulator's registers
    // to another value, which the D 256 block showed on the H100.
    float st[BK / 2], sw[SH::WIDE ? BK / 2 : 1], ot[NW / 2];
#pragma unroll
    for (int x = 0; x < BK / 2; ++x) st[x] = 0.0f;
#pragma unroll
    for (int x = 0; x < NW / 2; ++x) ot[x] = 0.0f;

    for (int it = 0; it < nk; ++it) {
      const int s = it % STAGES;
      mbar_wait(&full[s], (it / STAGES) & 1);
      const int j0 = (kbeg + it) * BK;
      const bool active = has_rows && j0 <= wk_hi && j0 + BK - 1 >= wk_lo;
      if (active) {
        const uint32_t kbig = smem_addr(ring + s * 4 * TILE);
        const uint32_t ksml = kbig + 4 * TILE;
        const uint32_t vbig = kbig + 8 * TILE;
        const uint32_t vsml = kbig + 12 * TILE;
        // ---- S = Q.K^T in 3xTF32.  The tensor cores' float32 sums round
        // with a bias, so the small terms go first: their sum stays small,
        // and the bias is that of big.big's KS (or QCH) steps alone.  WIDE
        // adds its QCH-step chunks with round-to-nearest ------------------
#pragma unroll
        for (int ks0 = 0; ks0 < KS; ks0 += QCH) {
          if constexpr (SH::WIDE) {
#pragma unroll
            for (int kk = 0; kk < QCH; ++kk)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                split(qsm[(rloc + 8 * (e & 1)) * SH::QROW + 8 * (ks0 + kk) +
                          c4 + 4 * (e >> 1)],
                      qb[kk][e], qs[kk][e]);
          }
          fence_regs(st);
          wgmma_fence();
#pragma unroll
          for (int half = 0; half < 2; ++half)
#pragma unroll
            for (int kk = 0; kk < QCH; ++kk) {
              const uint32_t at = (ks0 + kk) * 2 * BK * 16;
              const uint64_t db = make_desc(kbig + at, BK * 16, 128);
              const uint64_t ds = make_desc(ksml + at, BK * 16, 128);
              if constexpr (SH::WIDE) {
                if (half == 0) {
                  wgmma_rs<BK>(st, qs[kk], db, kk > 0);   // kk 0: afresh
                  wgmma_rs<BK>(st, qb[kk], ds, 1);
                } else {
                  wgmma_rs<BK>(st, qb[kk], db, 1);
                }
              } else {
                const uint32_t qa = (ks0 + kk) * 2 * BQ * 16 + 64 * wg * 16;
                const uint64_t dab =
                    make_desc(smem_addr(qbig) + qa, BQ * 16, 128);
                if (half == 0) {
                  const uint64_t das =
                      make_desc(smem_addr(qsml) + qa, BQ * 16, 128);
                  wgmma_ss_n32(st, das, db, kk > 0);     // kk 0: afresh
                  wgmma_ss_n32(st, dab, ds, 1);
                } else {
                  wgmma_ss_n32(st, dab, db, 1);
                }
              }
            }
          wgmma_commit();
          wgmma_wait_all();
          fence_regs(st);
          if constexpr (SH::WIDE) {
#pragma unroll
            for (int kk = 0; kk < QCH; ++kk) {
              fence_regs(qb[kk]);
              fence_regs(qs[kk]);
            }
#pragma unroll
            for (int x = 0; x < BK / 2; ++x)
              sw[x] = ks0 == 0 ? st[x] : __fadd_rn(sw[x], st[x]);
          }
        }
        // sacc: this tile's S (st itself unless WIDE)
        float* const sacc = SH::WIDE ? sw : st;
        // ---- online softmax on the fragment: sacc[4j + e] is row
        // r0 + 8 (e >> 1), key j0 + 8j + 2 c4 + (e & 1) -------------------
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int ri = e >> 1;
            const int t = j0 + 8 * j + 2 * c4 + (e & 1);
            float x = __fmul_rn(sacc[4 * j + e], a.scale);
            if (a.softcap > 0.0f)
              x = __fmul_rn(a.softcap, tanhf(__fdiv_rn(x, a.softcap)));
            const bool ok = valid[ri] && t < T && (!causal || t <= pos[ri]) &&
                            (window <= 0 || t > pos[ri] - window);
            x = ok ? x : -INFINITY;
            sacc[4 * j + e] = x;
            mx[ri] = fmaxf(mx[ri], x);
          }
        float alpha[2], m_use[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
        for (int ri = 0; ri < 2; ++ri) {
          mx[ri] = fmaxf(mx[ri], __shfl_xor_sync(FULL, mx[ri], 1));
          mx[ri] = fmaxf(mx[ri], __shfl_xor_sync(FULL, mx[ri], 2));
          const float m_new = fmaxf(m[ri], mx[ri]);
          m_use[ri] = m_new == -INFINITY ? 0.0f : m_new;
          alpha[ri] = expf(m[ri] - m_use[ri]);   // 0 while m is -inf
          m[ri] = m_new;
        }
        // P's A fragments for keys 8j .. 8j + 7: [0] row r0, slot c4 =
        // key 2 c4; [1] row r0 + 8; [2], [3] slot c4 + 4 = key 2 c4 + 1.
        // The producer stored V's keys of each group in the order
        // 0 2 4 6 1 3 5 7 to match.
        uint32_t pb[BK / 8][4], ps[BK / 8][4];
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int ri = e >> 1;
            const int slot = 2 * (e & 1) + ri;
            const float p = expf(sacc[4 * j + e] - m_use[ri]);
            rs[ri] = __fadd_rn(rs[ri], p);
            split(p, pb[j][slot], ps[j][slot]);
          }
#pragma unroll
        for (int ri = 0; ri < 2; ++ri) {
          rs[ri] = __fadd_rn(rs[ri], __shfl_xor_sync(FULL, rs[ri], 1));
          rs[ri] = __fadd_rn(rs[ri], __shfl_xor_sync(FULL, rs[ri], 2));
          l[ri] = fmaf(l[ri], alpha[ri], rs[ri]);
        }
        // ---- O = alpha O + P.V, P.V in 3xTF32 into a fresh accumulator
        // (one tile's 3 BK / 8 k-steps), added with one rounding (fmaf) ----
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          fence_regs(ot);
          wgmma_fence();
#pragma unroll
          for (int half = 0; half < 2; ++half)
#pragma unroll
            for (int j = 0; j < BK / 8; ++j) {
              const uint32_t at = j * 2 * DP * 16 + nb * NW * 16;
              const uint64_t db = make_desc(vbig + at, DP * 16, 128);
              if (half == 0) {   // the small terms first, j 0 afresh
                const uint64_t ds = make_desc(vsml + at, DP * 16, 128);
                wgmma_rs<NW>(ot, ps[j], db, j > 0);
                wgmma_rs<NW>(ot, pb[j], ds, 1);
              } else {
                wgmma_rs<NW>(ot, pb[j], db, 1);
              }
            }
          wgmma_commit();
          wgmma_wait_all();
          fence_regs(ot);
#pragma unroll
          for (int j = 0; j < BK / 8; ++j) {
            fence_regs(pb[j]);
            fence_regs(ps[j]);
          }
#pragma unroll
          for (int x = 0; x < NW / 2; ++x)
            o[nb][x] = fmaf(o[nb][x], alpha[(x >> 1) & 1], ot[x]);
        }
      }
      mbar_arrive(&empty[s]);
    }
  }

  // ---- the output: o[nb][4j + e] is row r0 + 8 (e >> 1), column
  // nb * NW + 8j + 2 c4 + (e & 1) ------------------------------------------
  if (cs == 1) {
    if (wg < SH::NWG) {
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int x = 0; x < NW / 2; ++x) {
          const int ri = (x >> 1) & 1;
          const int d = nb * NW + 8 * (x >> 2) + 2 * c4 + (x & 1);
          if (valid[ri] && d < D)
            a.out[row_off[ri] + d] =
                l[ri] > 0.0f ? __fdiv_rn(o[nb][x], l[ri]) : 0.0f;
        }
    }
    return;
  }
  // the key axis was split over the cluster: every block's partials go
  // to its own shared memory (the ring is free once both consumers are
  // done), and block `rank` merges rows rank * BQ / cs .. of all of them
  __syncthreads();
  if (wg < SH::NWG) {
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int x = 0; x < NW / 2; ++x) {
        const int ri = (x >> 1) & 1;
        const int d = nb * NW + 8 * (x >> 2) + 2 * c4 + (x & 1);
        ring[(rloc + 8 * ri) * DP + d] = o[nb][x];
      }
    if (c4 == 0) {
      m_sm[rloc] = m[0];
      m_sm[rloc + 8] = m[1];
      l_sm[rloc] = l[0];
      l_sm[rloc + 8] = l[1];
    }
  }
  cluster_sync();
  const int rows = BQ / cs;
  const uint32_t ring_a = smem_addr(ring);
  const uint32_t m_a = smem_addr(m_sm), l_a = smem_addr(l_sm);
  for (int idx = tid; idx < rows * DP; idx += SH::THREADS) {
    const int row = static_cast<int>(rank) * rows + idx / DP;
    const int d = idx % DP;
    const int vr = v0 + row;
    if (vr >= RV || d >= D) continue;
    float mm = -INFINITY;
    for (int qq = 0; qq < cs; ++qq)
      mm = fmaxf(mm, ld_cluster(m_a + 4 * row, qq));
    const float mu = mm == -INFINITY ? 0.0f : mm;
    float ll = 0.0f, oo = 0.0f;
    for (int qq = 0; qq < cs; ++qq) {
      const float w = expf(ld_cluster(m_a + 4 * row, qq) - mu);
      ll = __fadd_rn(ll, __fmul_rn(ld_cluster(l_a + 4 * row, qq), w));
      oo = __fadd_rn(oo, __fmul_rn(ld_cluster(ring_a + 4 * (row * DP + d),
                                              qq), w));
    }
    a.out[(static_cast<size_t>(b) * S + vr / G) * q_row +
          static_cast<size_t>(kvh * G + vr % G) * D + d] =
        ll > 0.0f ? __fdiv_rn(oo, ll) : 0.0f;
  }
  cluster_sync();   // no block leaves while another reads its partials
}

template <int DP>
int launch(const Args& a, int B, cudaStream_t stream) {
  using SH = Shape<DP>;
  static bool configured = false;   // the attribute is per kernel, once
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<SH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(SH::BYTES));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.n_tiles * a.cs, a.KV, B);
  cfg.blockDim = dim3(SH::THREADS, 1, 1);
  cfg.dynamicSmemBytes = SH::BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = a.cs > 1 ? 1 : 0;   // a lone block launches as usual
  const cudaError_t err = cudaLaunchKernelEx(&cfg, flash_attention_kernel<SH>, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

int padded_d(int D) {
  const int widths[5] = {16, 32, 48, 64, 80};
  for (int dp : widths)
    if (D <= dp) return dp;
  return 256;
}

}  // namespace

// Shared-memory bytes and query rows of the block shape for head dim D
// (kernels/flash_attention.py: plan mirrors them; a test holds the two
// equal on the card).
extern "C" void repro_flash_attention_shape(int D, int* out) {
  int bytes = 0, bq = 0;
  switch (padded_d(D)) {
    case 16: bytes = Shape<16>::BYTES; bq = Shape<16>::BQ; break;
    case 32: bytes = Shape<32>::BYTES; bq = Shape<32>::BQ; break;
    case 48: bytes = Shape<48>::BYTES; bq = Shape<48>::BQ; break;
    case 64: bytes = Shape<64>::BYTES; bq = Shape<64>::BQ; break;
    case 80: bytes = Shape<80>::BYTES; bq = Shape<80>::BQ; break;
    default: bytes = Shape<256>::BYTES; bq = Shape<256>::BQ; break;
  }
  out[0] = bytes;
  out[1] = bq;
}

// q (B, S, H, D), k and v (B, T, KV, D), out (B, S, H, D): contiguous
// float32 on the device.  H must be a multiple of KV; window <= 0 means
// none, softcap <= 0 means none; query row i sits at key position i + off
// (T - S aligns the queries to the end of the keys); cs (1, 2, 4 or 8) is
// the cluster's key split from the host's plan.  Launches on `stream` and returns the
// launch's cudaError_t (0 on success); a shape it does not take returns
// cudaErrorInvalidValue without launching.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int B, int S,
                                     int T, int H, int KV, int D, int causal,
                                     int window, float softcap, float scale,
                                     int off, int cs, void* stream) {
  if (B < 1 || S < 1 || T < 1 || KV < 1 || H < KV || H % KV != 0 || D < 1 ||
      D > MAX_D || KV > 65535 || B > 65535 ||
      !(cs == 1 || cs == 2 || cs == 4 || cs == 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const int dp = padded_d(D);
  const int bq = dp > 80 ? 64 : 128;
  const long long rows = static_cast<long long>(S) * (H / KV);
  Args a{static_cast<const float*>(q), static_cast<const float*>(k),
         static_cast<const float*>(v), static_cast<float*>(out), S, T, H, KV,
         D, causal, window, softcap, scale, cs,
         static_cast<int>((rows + bq - 1) / bq), 0, off};
  a.vec = (D % 4 == 0) && (reinterpret_cast<uintptr_t>(k) % 16 == 0) &&
          (reinterpret_cast<uintptr_t>(v) % 16 == 0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dp) {
    case 16: return launch<16>(a, B, st);
    case 32: return launch<32>(a, B, st);
    case 48: return launch<48>(a, B, st);
    case 64: return launch<64>(a, B, st);
    case 80: return launch<80>(a, B, st);
    default: return launch<256>(a, B, st);
  }
}
