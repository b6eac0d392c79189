// Kernel B1: W8A8 / W4A8 integer GEMM with int32 accumulation and the
// affine dequant epilogue, on Hopper's int8 tensor cores (sm_90a).
//
// Replaces repro/kernels/int8_matmul.py: int8_matmul_pallas (kernel
// _int8_matmul_kernel).  out[m, n] = (x_scale * w_scale[n]) * f32(corr),
//   corr = acc - xz * sum_k w[:, n] - wz[n] * sum_k x[m, :] + K * xz * wz[n]
// with acc = sum_k x[m, k] * w[k, n] in int32 and K the TRUE K.
//
// Bound on the H100: at the serving shapes (M <= 512, K, N <= 4096) the
// product is far below the int8 ridge point (~590 int8 ops per byte), so
// the bytes bound it (the f32 output and the codes, each moved once).  In
// practice the shapes are small enough that latency rules: the launch,
// the first loads, and how many SMs get work.  The design answers with
// tensor cores for the product, a grid that fills the card, and loads
// that run ahead of the product.
//
// Design.  A block of two warpgroups owns a 64 x BN output tile (BN in
// {8, 16, 32, 64}, host-chosen) and a range of K:
//  * warpgroup 1 (producer) stages 64-deep K tiles of x and w into a ring
//    of STAGES shared-memory stages, each guarded by a "full" and an
//    "empty" mbarrier, and keeps one tile of loads in registers ahead of
//    the one it stores;
//  * warpgroup 0 (consumer) waits on "full", issues
//    wgmma.mma_async.m64nBNk32.s32.s8.s8 on each 32-deep slice, waits for
//    it and releases the stage on "empty".
// The K-major shared layout both operands need (8-bit wgmma has no
// transpose) is the no-swizzle core-matrix layout: 8 rows x 16 bytes per
// core matrix, the 16-byte K chunks of all rows of a tile one after the
// other.  x (M, K) is K-contiguous and goes in as 16-byte vectors (byte by
// byte where K % 16 != 0 or at the ragged K edge).  w (K, N) is
// N-contiguous (the JAX layout, kept by PackedTensor), so the producer
// reads 4 x 4 byte blocks as four 32-bit rows (int4: two packed rows,
// nibbles sign-extended), transposes them in registers with __byte_perm
// and stores four K-major words.  A K-major copy of w made at pack time
// would skip that transpose, but the layer weights are 64 KB (Policy II)
// to 2 MB (Policy III), the transpose is a few instructions per 16 bytes
// hidden behind the loads, and a second copy beside every PackedTensor
// would double the cache's bytes and its hot-swap traffic; so w is
// transposed on the way in.
// The host's plan fills the card: where K is long (8 stages or more) and
// the tiles are fewer than SPLIT_TARGET, the K range is split over a
// thread block cluster of 2 or 4 blocks (two 33 KB blocks fit an SM),
// whose int32 partial products and sums are added through distributed
// shared memory (integers add exactly) in the same launch, each block
// finishing 64 / cs rows of the tile; then N tiles narrow to 16 while that
// adds tiles and they number fewer than TILE_TARGET.  A lone block (cs ==
// 1) launches without a cluster and reads its own partials.
// M is padded to 64 rows, N to BN and K to the 32-deep wgmma slice with
// zero codes, which add nothing to acc or to the sums; the store masks the
// ragged edges, and the cross term keeps the true K.  The row sums of x
// and the column sums of w are taken by the producer from the staged
// registers with __dp4a (exact int32).  At these shapes the kernel is a
// chain of latencies, so the epilogue's scales are loaded at its start.
// (Issuing the producer's first tile there as well slowed the long-K
// rows on the H100, so that stays in the producer's loop.)
//
// Bitwise agreement with the plain version (kernels/ref.py): the integer
// sum is exact in any order (|acc| <= K * 128 * 128 < 2**31 for K up to
// 131,071: the conv actor's longest K, Policy C's fc at 102,400, gives at
// most 1.68e9); the corrected bracket can pass 2**31 only for codes at the
// ends of their range, and then wraps in int32 as the plain version's int32
// arithmetic (and the reference oracle's) does; the
// epilogue rounds each float op on its own (__fmul_rn; the library is also
// built with -fmad=false), and int -> float is round-to-nearest
// (__int2float_rn).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BM = 64;            // output rows of a tile (wgmma M)
constexpr int BK = 64;            // K depth of a stage: two k32 slices
constexpr int BN_MAX = 64;
constexpr int STAGES = 4;
constexpr int THREADS = 256;      // consumer + producer warpgroup
constexpr int A_STAGE = BM * BK;
constexpr int B_STAGE = BN_MAX * BK;
constexpr int RING = STAGES * (A_STAGE + B_STAGE);
constexpr int TILE_TARGET = 128;  // tiles that fill the card at 1 block/SM
constexpr int SPLIT_TARGET = 256; // blocks for long K (2 per SM co-resident)
constexpr int MIN_SPLIT_STEPS = 8;

static_assert(BM * BN_MAX * 4 <= RING, "the tile's partials reuse the ring");
static_assert(THREADS % BN_MAX == 0, "an epilogue thread keeps one column");

struct Smem {
  alignas(128) int8_t ring[RING];  // A stages, then B stages; then acc
  int sum_x[BM];
  int sum_w[BN_MAX];
  alignas(8) uint64_t full[STAGES];
  alignas(8) uint64_t empty[STAGES];
};

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

// int32 at shared address `addr` of block `rank` of the cluster
__device__ __forceinline__ int ld_cluster(uint32_t addr, uint32_t rank) {
  uint32_t remote;
  int v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(addr), "r"(rank));
  asm volatile("ld.shared::cluster.s32 %0, [%1];\n"
               : "=r"(v)
               : "r"(remote)
               : "memory");
  return v;
}

// wgmma shared-memory matrix descriptor, no swizzle (layout type 0):
// start address, the byte stride between core matrices along K (the
// leading byte offset) and along M / N (the stride byte offset)
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

template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_n8(int (&d)[4], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "l"(da), "l"(db));
}

__device__ __forceinline__ void wgmma_n16(int (&d)[8], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
      : "l"(da), "l"(db));
}

__device__ __forceinline__ void wgmma_n32(int (&d)[16], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(da), "l"(db));
}

__device__ __forceinline__ void wgmma_n64(int (&d)[32], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db));
}


template <int BN>
__device__ __forceinline__ void wgmma_slice(int (&d)[BN / 2], uint64_t da,
                                            uint64_t db) {
  if constexpr (BN == 8) wgmma_n8(d, da, db);
  else if constexpr (BN == 16) wgmma_n16(d, da, db);
  else if constexpr (BN == 32) wgmma_n32(d, da, db);
  else wgmma_n64(d, da, db);
}

__device__ __forceinline__ int sext4(uint32_t v) {
  return static_cast<int>(v << 28) >> 28;
}

__device__ __forceinline__ int8_t load_w(const int8_t* __restrict__ w, int k,
                                         int n, int K, int N, int w_bits) {
  if (k >= K || n >= N) return 0;
  if (w_bits <= 4) {
    const uint32_t b = static_cast<uint8_t>(w[static_cast<size_t>(k >> 1) * N + n]);
    return static_cast<int8_t>((k & 1) ? sext4(b >> 4) : sext4(b & 0xF));
  }
  return w[static_cast<size_t>(k) * N + n];
}

// What one producer thread holds of a stage between its loads and its
// stores: two 16-byte chunks of x and up to two 4 x 4 blocks of w.
struct Staged {
  uint4 x[2];
  uint32_t w[2][4];
};

template <int BN>
struct Producer {
  static constexpr int NG = BN / 4;            // 4-column groups
  static constexpr int UNITS = 16 * NG;        // 4 x 4 blocks of a stage
  static constexpr int UPT = UNITS > 128 ? UNITS / 128 : 1;

  const int8_t* x;
  const int8_t* w;
  int M, K, N, w_bits, m0, n0, pt;
  bool vec_x, vec_w;

  // 32-deep slices of stage kt that hold any of the true K
  __device__ int slices(int kt) const {
    const int left = K - kt * BK;
    return left >= 32 ? 2 : 1;
  }

  __device__ bool w_fast(int k, int n) const {
    return vec_w && n + 3 < N && k + 3 < K;
  }

  __device__ void load(int kt, Staged& s) const {
    const int nsl = slices(kt);
    const int row = pt & 63;
    const int m = m0 + row;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = (pt >> 6) + 2 * i;
      const int k = kt * BK + 16 * c;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (c < 2 * nsl && m < M) {
        const int8_t* src = x + static_cast<size_t>(m) * K + k;
        if (vec_x && k + 16 <= K) {
          v = *reinterpret_cast<const uint4*>(src);
        } else {
          uint32_t b[4] = {0, 0, 0, 0};
#pragma unroll
          for (int j = 0; j < 16; ++j)
            if (k + j < K)
              b[j >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(src[j]))
                           << (8 * (j & 3));
          v = make_uint4(b[0], b[1], b[2], b[3]);
        }
      }
      s.x[i] = v;
    }
#pragma unroll
    for (int i = 0; i < UPT; ++i) {
      const int u = pt + 128 * i;
      const int ng = u % NG, kg = u / NG;
      const int n = n0 + 4 * ng, k = kt * BK + 4 * kg;
      uint32_t* r = s.w[i];
      r[0] = r[1] = r[2] = r[3] = 0;
      if (u >= UNITS || (kg >> 3) >= nsl) continue;
      if (w_fast(k, n)) {
        if (w_bits <= 4) {
          const int8_t* src = w + static_cast<size_t>(k >> 1) * N + n;
          r[0] = *reinterpret_cast<const uint32_t*>(src);
          r[1] = *reinterpret_cast<const uint32_t*>(src + N);
        } else {
          const int8_t* src = w + static_cast<size_t>(k) * N + n;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            r[j] = *reinterpret_cast<const uint32_t*>(src + j * N);
        }
      } else {              // ragged edge: K-major words, byte by byte
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int ii = 0; ii < 4; ++ii)
            r[jj] |= static_cast<uint32_t>(static_cast<uint8_t>(
                         load_w(w, k + ii, n + jj, K, N, w_bits)))
                     << (8 * ii);
      }
    }
  }

  // The stage's K-major words into shared memory, and the row / column
  // sums of what was staged.
  __device__ void store(int kt, const Staged& s, int8_t* a_st, int8_t* b_st,
                        int& sx, int (&sw)[4]) const {
    const int row = pt & 63;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = (pt >> 6) + 2 * i;
      const uint4 v = s.x[i];
      *reinterpret_cast<uint4*>(a_st + c * (BM * 16) + row * 16) = v;
      sx = __dp4a(static_cast<int>(v.x), 0x01010101, sx);
      sx = __dp4a(static_cast<int>(v.y), 0x01010101, sx);
      sx = __dp4a(static_cast<int>(v.z), 0x01010101, sx);
      sx = __dp4a(static_cast<int>(v.w), 0x01010101, sx);
    }
#pragma unroll
    for (int i = 0; i < UPT; ++i) {
      const int u = pt + 128 * i;
      if (u >= UNITS) continue;
      const int ng = u % NG, kg = u / NG;
      const int n = n0 + 4 * ng, k = kt * BK + 4 * kg;
      const uint32_t* r = s.w[i];
      uint32_t col[4];
      if ((kg >> 3) < slices(kt) && w_fast(k, n)) {
        if (w_bits <= 4) {
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const uint32_t b0 = (r[0] >> (8 * jj)) & 0xFF;
            const uint32_t b1 = (r[1] >> (8 * jj)) & 0xFF;
            col[jj] = (static_cast<uint32_t>(sext4(b0 & 0xF)) & 0xFF) |
                      ((static_cast<uint32_t>(sext4(b0 >> 4)) & 0xFF) << 8) |
                      ((static_cast<uint32_t>(sext4(b1 & 0xF)) & 0xFF) << 16) |
                      ((static_cast<uint32_t>(sext4(b1 >> 4)) & 0xFF) << 24);
          }
        } else {
          const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
          const uint32_t t1 = __byte_perm(r[2], r[3], 0x5140);
          const uint32_t t2 = __byte_perm(r[0], r[1], 0x7362);
          const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
          col[0] = __byte_perm(t0, t1, 0x5410);
          col[1] = __byte_perm(t0, t1, 0x7632);
          col[2] = __byte_perm(t2, t3, 0x5410);
          col[3] = __byte_perm(t2, t3, 0x7632);
        }
      } else {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) col[jj] = r[jj];
      }
      const int kb = 4 * kg;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        *reinterpret_cast<uint32_t*>(b_st + (kb >> 4) * (BN * 16) +
                                     (4 * ng + jj) * 16 + (kb & 15)) = col[jj];
        sw[jj] = __dp4a(static_cast<int>(col[jj]), 0x01010101, sw[jj]);
      }
    }
  }
};

template <int BN>
__global__ void __launch_bounds__(THREADS)
int8_matmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ x_scale,
                   const float* __restrict__ x_zero,
                   const float* __restrict__ w_scale,
                   const float* __restrict__ w_zero, float* __restrict__ out,
                   int M, int K, int N, int w_bits, int cs, int vec_x,
                   int vec_w) {
  __shared__ Smem sm;
  const int tid = threadIdx.x;
  const uint32_t rank = cs > 1 ? cluster_rank() : 0;
  const int m0 = blockIdx.y * BM;
  const int n0 = (blockIdx.x / cs) * BN;
  const int k_steps = (K + BK - 1) / BK;
  const int kbeg = static_cast<int>(rank) * k_steps / cs;
  const int nk = (static_cast<int>(rank) + 1) * k_steps / cs - kbeg;

  // the epilogue's scalars, loaded now so that their latency hides under
  // the K loop: each thread finishes one column of the tile
  // (THREADS % BN == 0), so it needs one w_scale and one w_zero
  const int ecol = tid % BN;
  const int en = n0 + ecol;
  const float ews = en < N ? w_scale[en] : 0.0f;
  const int ewz = en < N ? static_cast<int>(w_zero[en]) : 0;
  const float xs = *x_scale;
  const int xz = static_cast<int>(*x_zero);

  if (tid < BM) sm.sum_x[tid] = 0;
  if (tid < BN_MAX) sm.sum_w[tid] = 0;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.full[s], 128);
      mbar_init(&sm.empty[s], 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  int8_t* const a_ring = sm.ring;
  int8_t* const b_ring = sm.ring + STAGES * A_STAGE;
  int* const red = reinterpret_cast<int*>(sm.ring);   // after the K loop

  if (tid < 128) {
    // ---- consumer: wgmma over the staged slices ------------------------
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    for (int it = 0; it < nk; ++it) {
      const int s = it % STAGES;
      mbar_wait(&sm.full[s], (it / STAGES) & 1);
      const int nsl = K - (kbeg + it) * BK >= 32 ? 2 : 1;
      const uint32_t a0 = smem_addr(a_ring + s * A_STAGE);
      const uint32_t b0 = smem_addr(b_ring + s * B_STAGE);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 2; ++j)
        if (j < nsl)
          wgmma_slice<BN>(acc,
                          make_desc(a0 + j * 2 * BM * 16, BM * 16, 128),
                          make_desc(b0 + j * 2 * BN * 16, BN * 16, 128));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      mbar_arrive(&sm.empty[s]);
    }
    // `red` aliases the A ring, and each warp's wait orders only its own
    // part of the warpgroup's last wgmma: the consumer's four warps meet
    // at named barrier 1 before any of them overwrites operand bytes
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
    // the accumulator fragment (PTX ISA, wgmma .m64nNk32 D layout): for
    // each 8-column group j, thread (warp w, lane l) holds rows
    // 16w + l/4 and 16w + l/4 + 8, columns 8j + 2(l%4) and the next
    const int warp = tid >> 5, lane = tid & 31;
    const int r0 = 16 * warp + (lane >> 2);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = 8 * j + 2 * (lane & 3);
      *reinterpret_cast<int2*>(red + r0 * BN + c) =
          make_int2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<int2*>(red + (r0 + 8) * BN + c) =
          make_int2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  } else {
    // ---- producer: the ring, one stage of loads ahead ------------------
    Producer<BN> p{x, w, M, K, N, w_bits, m0, n0, tid - 128,
                   vec_x != 0, vec_w != 0};
    int sx = 0;
    int sw[4] = {0, 0, 0, 0};
    Staged cur, nxt;
    if (nk > 0) p.load(kbeg, cur);
    for (int it = 0; it < nk; ++it) {
      const int s = it % STAGES;
      if (it + 1 < nk) p.load(kbeg + it + 1, nxt);
      if (it >= STAGES) mbar_wait(&sm.empty[s], ((it / STAGES) - 1) & 1);
      p.store(kbeg + it, cur, a_ring + s * A_STAGE, b_ring + s * B_STAGE,
              sx, sw);
      fence_async_shared();
      mbar_arrive(&sm.full[s]);
      cur = nxt;
    }
    atomicAdd(&sm.sum_x[p.pt & 63], sx);
    if (p.pt < Producer<BN>::UNITS) {
      const int ng = p.pt % Producer<BN>::NG;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) atomicAdd(&sm.sum_w[4 * ng + jj], sw[jj]);
    }
  }

  // every block's partials are in its shared memory: add them up (a
  // block of its own, cs == 1, reads its own)
  if (cs > 1) cluster_sync();
  else __syncthreads();
  const int rows = BM / cs;
  const int row0 = static_cast<int>(rank) * rows;
  const uint32_t red_a = smem_addr(red);
  const uint32_t sx_a = smem_addr(sm.sum_x);
  const uint32_t sw_a = smem_addr(sm.sum_w);
  for (int idx = tid; idx < rows * BN; idx += THREADS) {
    const int row = row0 + idx / BN, col = ecol;   // idx % BN == ecol
    const int m = m0 + row, n = en;
    if (m >= M || n >= N) continue;
    int acc, sxm, swn;
    if (cs == 1) {
      acc = red[row * BN + col];
      sxm = sm.sum_x[row];
      swn = sm.sum_w[col];
    } else {
      acc = sxm = swn = 0;
      for (int q = 0; q < cs; ++q) {
        acc += ld_cluster(red_a + 4 * (row * BN + col), q);
        sxm += ld_cluster(sx_a + 4 * row, q);
        swn += ld_cluster(sw_a + 4 * col, q);
      }
    }
    const int corr = acc - xz * swn - ewz * sxm + K * xz * ewz;
    out[static_cast<size_t>(m) * N + n] =
        __fmul_rn(__fmul_rn(xs, ews), __int2float_rn(corr));
  }
  if (cs > 1) cluster_sync();  // no block leaves while another reads
}

void plan(int M, int K, int N, int* bn_out, int* cs_out) {
  const int m_tiles = (M + BM - 1) / BM;
  const int k_steps = (K + BK - 1) / BK;
  int bn = 8;
  while (bn < N && bn < BN_MAX) bn *= 2;
  auto tiles = [&](int b) { return m_tiles * ((N + b - 1) / b); };
  int cs = 1;
  if (k_steps >= MIN_SPLIT_STEPS)   // long K: split it over a cluster
    while (cs < 4 && tiles(bn) * cs < SPLIT_TARGET &&
           k_steps / (2 * cs) >= 2)
      cs *= 2;
  // then narrower N tiles while that still adds tiles
  while (tiles(bn) * cs < TILE_TARGET && bn > 16 && tiles(bn / 2) > tiles(bn))
    bn /= 2;
  *bn_out = bn;
  *cs_out = cs;
}

template <int BN>
cudaError_t launch(const void* x, const void* w, const void* x_scale,
                   const void* x_zero, const void* w_scale,
                   const void* w_zero, void* out, int M, int K, int N,
                   int w_bits, int cs, cudaStream_t stream) {
  const int vec_x = (K % 16 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  const int vec_w = (N % 4 == 0) && (reinterpret_cast<uintptr_t>(w) % 4 == 0);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((N + BN - 1) / BN) * cs, (M + BM - 1) / BM, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cs > 1 ? 1 : 0;   // a lone block launches as usual
  return cudaLaunchKernelEx(
      &cfg, int8_matmul_kernel<BN>, static_cast<const int8_t*>(x),
      static_cast<const int8_t*>(w), static_cast<const float*>(x_scale),
      static_cast<const float*>(x_zero), static_cast<const float*>(w_scale),
      static_cast<const float*>(w_zero), static_cast<float*>(out), M, K, N,
      w_bits, cs, vec_x, vec_w);
}

}  // namespace

// The tile plan of an (M, K, N) product: plan[0] = BN, plan[1] = the
// cluster's K split, plan[2] = blocks launched.
extern "C" void repro_int8_matmul_plan(int M, int K, int N, int* out) {
  int bn, cs;
  plan(M, K, N, &bn, &cs);
  out[0] = bn;
  out[1] = cs;
  out[2] = ((N + bn - 1) / bn) * cs * ((M + BM - 1) / BM);
}

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int repro_int8_matmul(const void* x, const void* w,
                                 const void* x_scale, const void* x_zero,
                                 const void* w_scale, const void* w_zero,
                                 void* out, int M, int K, int N, int w_bits,
                                 void* stream) {
  if (M < 1 || K < 1 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  int bn, cs;
  plan(M, K, N, &bn, &cs);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  auto go = [&](auto bn_c) {
    return launch<decltype(bn_c)::value>(x, w, x_scale, x_zero, w_scale,
                                         w_zero, out, M, K, N, w_bits, cs,
                                         st);
  };
  switch (bn) {
    case 8: err = go(std::integral_constant<int, 8>{}); break;
    case 16: err = go(std::integral_constant<int, 16>{}); break;
    case 32: err = go(std::integral_constant<int, 32>{}); break;
    default: err = go(std::integral_constant<int, 64>{}); break;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
