// Kernel B2: the whole quantized MLP actor forward in one launch, sm_90a.
//
// Replaces repro/kernels/fused_qmlp.py: fused_qmlp_pallas (kernel
// _fused_qmlp_kernel, per-layer _layer_forward).  Every layer is the W8A8
// (or W4A8) GEMM with int32 accumulation, the zero-point correction on the
// true K and the dequant epilogue; each hidden layer then adds its bias,
// applies ReLU and requantizes statically to the next layer's input params,
//   h' = clip(rint(relu(y) / x_delta') + x_zero', -128, 127),
// so inter-layer activations stay int8 in shared memory.  Only the head
// writes f32.
//
// Bound on the H100: latency.  The work is tiny against the card (the
// CartPole net 4-64-64-2 at M = 8 is 72 K int8 ops and 4.5 KB of codes;
// Policy II, 9-256-256-256-25, at M = 512 is 0.14 G ops and 140 KB), so
// the bytes and operations bounds are fractions of a microsecond and the
// time is the launch, the prologue's round trips to L2 and the chain of
// layers: per layer a barrier, the K loop's loads and mma's, and the
// epilogue with its correctly rounded divide.  The design shortens the
// chain: the codes sit in shared memory as the fragments want them, and
// every warp works at every layer.  Measured on the H100
// (tools/kernel_ablation.py), the requant's divide and the transpose of
// the codes in shared memory are each about a fifth of the time at
// Policy II; the codes' copies are hidden behind the layers before.
//
// Layout: one block of 256 threads (8 warps) owns ROWS = 16 rows (one
// m16 tile) and walks every layer.
//  * Staging.  At the start each thread issues 16-byte cp.async copies of
//    the codes of every layer that fits beside the activations (the
//    host's plan: Policy II whole; Policy III's wide layers stay in
//    global memory and stream through L2), one commit group a layer, so
//    that they arrive while the layers before compute.  Before layer l
//    the block waits for its group and transposes its codes in shared
//    memory into one K-major buffer, as the B fragment wants them: 4 x 4
//    blocks of codes, transposed in registers with __byte_perm (int4:
//    nibbles sign-extended), four words stored into rows padded so that
//    a fragment's loads hit distinct banks.  (Staging K-major straight
//    from global memory put its round trips to L2 on the critical path:
//    a third of the kernel at Policy II on the H100.)
//  * Compute.  mma.sync m16n8k32 s8 x s8 -> s32 tensor-core tiles.  A is
//    the int8 activation tile in shared memory, row stride a multiple of
//    32 plus 16 bytes so the fragment loads hit distinct banks.  B is two
//    words of the staged K-major codes, or for a streamed layer gathered
//    from its (K, N) codes, four codes of one column into a word.  A
//    layer's n8 tiles are spread over the 8 warps; where they are fewer
//    than 8 (the 2-wide head, narrow layers) the K steps
//    are split too, and the int32 partials meet in shared memory.  Row
//    sums of the activations and column sums of the codes are __dp4a's of
//    the same fragments, reduced over the 4 lanes that share a row or a
//    column.  K is padded to the 32-deep step with zero codes (activation
//    columns past the layer's input width are kept 0, codes past K read
//    as 0); the cross term keeps the true K.
//  * Epilogue, straight from the accumulator fragment.
//
// Bitwise agreement with the plain version (kernels/ref.py): integer sums
// are exact in any order; the epilogue rounds each op on its own, in the
// reference's order -- (x_delta * col_scale) * f32(corr), then + bias --
// with __fmul_rn / __fadd_rn (the library is also built with -fmad=false);
// the requant divide is correctly rounded (__fdiv_rn) and rounds half to
// even (rintf).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_LAYERS = 8;
constexpr int ROWS = 16;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SMEM_LIMIT = 232448;
constexpr unsigned FULL = 0xffffffffu;

struct QMLPArgs {
  const int8_t* codes[MAX_LAYERS];
  const float* col_scale[MAX_LAYERS];
  const float* col_zero[MAX_LAYERS];
  const float* bias[MAX_LAYERS];
  const float* x_delta[MAX_LAYERS];
  const float* x_zero[MAX_LAYERS];
  int k[MAX_LAYERS];
  int n[MAX_LAYERS];
  int bits[MAX_LAYERS];
  int staged[MAX_LAYERS];   // byte offset of the codes' copy in shared
                            // memory, or -1 (read from global memory)
  int kmajor;               // byte offset of the K-major buffer
  int n_layers;
  int stride;               // activation row stride, bytes
  int red;                  // byte offset of the split-K partials
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wait until at most `n` of this thread's cp.async groups are pending
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

__device__ __forceinline__ uint32_t sext4(uint32_t v) {
  return static_cast<uint32_t>(static_cast<int>(v << 28) >> 28) & 0xFFu;
}

// codes w[k .. k+3][n] as one K-major word (k % 4 == 0), 0 past K or N;
// `w` points into shared or global memory
__device__ __forceinline__ uint32_t b_word(const int8_t* w, int k, int n,
                                           int K, int N, int bits) {
  if (n >= N) return 0;
  uint32_t r = 0;
  if (k + 4 <= K) {   // a whole word of the true K
    if (bits <= 4) {
      const uint32_t b0 = static_cast<uint8_t>(w[(k >> 1) * N + n]);
      const uint32_t b1 = static_cast<uint8_t>(w[((k >> 1) + 1) * N + n]);
      return sext4(b0 & 0xFu) | (sext4(b0 >> 4) << 8) |
             (sext4(b1 & 0xFu) << 16) | (sext4(b1 >> 4) << 24);
    }
    return static_cast<uint32_t>(static_cast<uint8_t>(w[k * N + n])) |
           (static_cast<uint32_t>(static_cast<uint8_t>(w[(k + 1) * N + n]))
            << 8) |
           (static_cast<uint32_t>(static_cast<uint8_t>(w[(k + 2) * N + n]))
            << 16) |
           (static_cast<uint32_t>(static_cast<uint8_t>(w[(k + 3) * N + n]))
            << 24);
  }
  if (bits <= 4) {
#pragma unroll
    for (int i = 0; i < 4; i += 2) {
      if (k + i >= K) break;
      const uint32_t b = static_cast<uint8_t>(w[((k + i) >> 1) * N + n]);
      const uint32_t hi = k + i + 1 < K ? sext4(b >> 4) : 0u;
      r |= (sext4(b & 0xFu) | (hi << 8)) << (8 * i);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (k + i < K)
        r |= static_cast<uint32_t>(static_cast<uint8_t>(w[(k + i) * N + n]))
             << (8 * i);
  }
  return r;
}

// Layer codes (K, N) (int4: packed pairs along K) as K-major words: row n
// (N rounded up to 8) holds K rounded up to 32 codes, four to a word,
// with a row stride of `sw` words (= K / 4 + 4 rounded, so that a
// fragment's 8 rows x 4 words hit distinct banks); zero past K and N.
// The work is 4 x 4 blocks, a warp's 32 taking 8 along K by 4 along N
// (the stores then meet at most 2-way bank conflicts): a thread loads a
// block's rows, transposes them in registers and stores four words.
struct KMajor {
  uint32_t* wt;
  const int8_t* w;
  int K, N, bits, sw, kb8, np4;
  bool fast;

  __device__ void block(int u, int& k, int& n) const {
    const int rest = u >> 5;
    k = 4 * (8 * (rest % kb8) + (u & 7));
    n = 4 * (4 * (rest / kb8) + ((u >> 3) & 3));
  }

  __device__ bool whole(int k, int n) const {
    return fast && n < N && k + 4 <= K;
  }

  __device__ void load(int u, uint32_t (&r)[4]) const {
    int k, n;
    block(u, k, n);
    if (!whole(k, n)) return;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i < (bits <= 4 ? 2 : 4))
        r[i] = *reinterpret_cast<const uint32_t*>(
            w + ((bits <= 4 ? k >> 1 : k) + i) * N + n);
  }

  __device__ void store(int u, const uint32_t (&r)[4]) const {
    int k, n;
    block(u, k, n);
    if (n >= 4 * np4) return;
    uint32_t col[4];
    if (whole(k, n)) {
      if (bits <= 4) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const uint32_t b0 = (r[0] >> (8 * jj)) & 0xFF;
          const uint32_t b1 = (r[1] >> (8 * jj)) & 0xFF;
          col[jj] = sext4(b0 & 0xF) | (sext4(b0 >> 4) << 8) |
                    (sext4(b1 & 0xF) << 16) | (sext4(b1 >> 4) << 24);
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
    } else {   // the ragged edge, code by code
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) col[jj] = b_word(w, k, n + jj, K, N, bits);
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) wt[(n + jj) * sw + k / 4] = col[jj];
  }
};

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One warp's share of an n8 tile over k-steps [ks0, ks1): the int32
// accumulator fragment (c[0], c[1]: row g, columns n0 + 2t, + 1; c[2],
// c[3]: row g + 8), this lane's partial row sums of rows g and g + 8 and
// column sum of column n0 + g.
struct Part {
  int c[4];
  int sx[2];
  int sw;
};

__device__ __forceinline__ Part tile_part(const int8_t* h, int stride,
                                          const uint32_t* wt, int sw,
                                          const int8_t* w, int K, int N,
                                          int bits, int n0, int ks0, int ks1,
                                          int lane) {
  const int g = lane >> 2, t = lane & 3;
  Part p = {{0, 0, 0, 0}, {0, 0}, 0};
  const int8_t* h0 = h + g * stride + 4 * t;
  const int8_t* h8 = h0 + 8 * stride;
#pragma unroll 8
  for (int ks = ks0; ks < ks1; ++ks) {
    const int k0 = 32 * ks;
    const uint32_t a[4] = {*reinterpret_cast<const uint32_t*>(h0 + k0),
                           *reinterpret_cast<const uint32_t*>(h8 + k0),
                           *reinterpret_cast<const uint32_t*>(h0 + k0 + 16),
                           *reinterpret_cast<const uint32_t*>(h8 + k0 + 16)};
    uint32_t b0, b1;
    if (wt != nullptr) {   // staged K-major: two conflict-free words
      b0 = wt[(n0 + g) * sw + 8 * ks + t];
      b1 = wt[(n0 + g) * sw + 8 * ks + 4 + t];
    } else {               // streamed: gathered from the (K, N) codes
      b0 = b_word(w, k0 + 4 * t, n0 + g, K, N, bits);
      b1 = b_word(w, k0 + 16 + 4 * t, n0 + g, K, N, bits);
    }
    mma_s8(p.c, a, b0, b1);
    p.sx[0] = __dp4a(static_cast<int>(a[0]), 0x01010101, p.sx[0]);
    p.sx[0] = __dp4a(static_cast<int>(a[2]), 0x01010101, p.sx[0]);
    p.sx[1] = __dp4a(static_cast<int>(a[1]), 0x01010101, p.sx[1]);
    p.sx[1] = __dp4a(static_cast<int>(a[3]), 0x01010101, p.sx[1]);
    p.sw = __dp4a(static_cast<int>(b0), 0x01010101, p.sw);
    p.sw = __dp4a(static_cast<int>(b1), 0x01010101, p.sw);
  }
  return p;
}

__global__ void __launch_bounds__(THREADS, 1)
fused_qmlp_kernel(const int8_t* __restrict__ x, int M, int K0, QMLPArgs a,
                  float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* buf[2] = {reinterpret_cast<int8_t*>(smem),
                    reinterpret_cast<int8_t*>(smem) + ROWS * a.stride};
  int* const red = reinterpret_cast<int*>(smem + a.red);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * ROWS;

  // the input codes of this block's rows (rows past M and the K tail are
  // zero), then the codes
  const int k0_32 = (K0 + 31) & ~31;
  for (int i = tid; i < ROWS * k0_32; i += THREADS) {
    const int r = i / k0_32, c = i % k0_32;
    const int m = row0 + r;
    buf[0][r * a.stride + c] =
        (m < M && c < K0) ? x[static_cast<size_t>(m) * K0 + c] : 0;
  }

  // every staged layer's codes in flight, one commit group a layer
  for (int l = 0; l < a.n_layers; ++l) {
    if (a.staged[l] >= 0) {
      const int bytes =
          (a.bits[l] <= 4 ? (a.k[l] + 1) / 2 : a.k[l]) * a.n[l];
      const int8_t* src = a.codes[l];
      int8_t* dst = reinterpret_cast<int8_t*>(smem + a.staged[l]);
      const int head =
          reinterpret_cast<uintptr_t>(src) % 16 == 0 ? bytes & ~15 : 0;
      for (int i = 16 * tid; i < head; i += 16 * THREADS)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                         smem_addr(dst + i)),
                     "l"(src + i)
                     : "memory");
      for (int i = head + tid; i < bytes; i += THREADS) dst[i] = src[i];
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  int cur = 0;
  for (int l = 0; l < a.n_layers; ++l) {
    const int K = a.k[l], N = a.n[l], bits = a.bits[l];
    const int KS = (K + 31) / 32;
    const int NT = (N + 7) / 8;
    const int8_t* h = buf[cur];
    int8_t* h_next = buf[cur ^ 1];
    const bool last = (l + 1 == a.n_layers);
    cp_async_wait(a.n_layers - 1 - l);
    __syncthreads();   // this layer's codes and input are in place
    uint32_t* const wt =
        a.staged[l] >= 0 ? reinterpret_cast<uint32_t*>(smem + a.kmajor)
                         : nullptr;
    const int sw = KS * 8 + 4;
    if (wt != nullptr) {   // the copy, K-major, into the shared buffer
      const int np4 = 2 * NT;
      const KMajor km{wt, reinterpret_cast<const int8_t*>(smem + a.staged[l]),
                      K, N, bits, sw, KS, np4, N % 4 == 0};
      const int units = 8 * KS * ((np4 + 3) & ~3);
      for (int u = tid; u < units; u += THREADS) {
        uint32_t r[4];
        km.load(u, r);
        km.store(u, r);
      }
      __syncthreads();
    }

    const float xd = *a.x_delta[l];
    const int xz = static_cast<int>(*a.x_zero[l]);
    const float nxd = last ? 1.0f : *a.x_delta[l + 1];
    const float nxz = last ? 0.0f : *a.x_zero[l + 1];
    // split K where the tiles are fewer than the warps
    const int kspl = NT >= WARPS ? 1 : min(KS, WARPS / NT);
    const int items = NT * kspl;

    const int rounds = (items + WARPS - 1) / WARPS;   // alike in every warp
    for (int rd = 0; rd < rounds; ++rd) {
      const int item = warp + WARPS * rd;
      const bool mine = item < items;
      const int nt = item / kspl, part = item % kspl;
      Part p = {{0, 0, 0, 0}, {0, 0}, 0};
      if (mine)
        p = tile_part(h, a.stride, wt, sw, a.codes[l], K, N, bits, 8 * nt,
                      part * KS / kspl, (part + 1) * KS / kspl, lane);
      if (kspl > 1) {   // items <= WARPS: one item a warp, partials meet
        int* r = red + (warp * 32 + lane) * 7;
        r[0] = p.c[0];
        r[1] = p.c[1];
        r[2] = p.c[2];
        r[3] = p.c[3];
        r[4] = p.sx[0];
        r[5] = p.sx[1];
        r[6] = p.sw;
        __syncthreads();
        if (!mine || part != 0) continue;
        for (int q = 1; q < kspl; ++q) {
          const int* o = red + ((warp + q) * 32 + lane) * 7;
          p.c[0] += o[0];
          p.c[1] += o[1];
          p.c[2] += o[2];
          p.c[3] += o[3];
          p.sx[0] += o[4];
          p.sx[1] += o[5];
          p.sw += o[6];
        }
      } else if (!mine) {
        continue;
      }
      // the sums over the 4 lanes of a row (t) and of a column (g)
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        p.sx[0] += __shfl_xor_sync(FULL, p.sx[0], off);
        p.sx[1] += __shfl_xor_sync(FULL, p.sx[1], off);
        p.sw += __shfl_xor_sync(FULL, p.sw, off);
      }
      const int sw_e[2] = {__shfl_sync(FULL, p.sw, 4 * (2 * t)),
                           __shfl_sync(FULL, p.sw, 4 * (2 * t + 1))};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = g + 8 * (e >> 1);
        const int n = 8 * nt + 2 * t + (e & 1);
        if (n >= N) {
          if (!last) h_next[r * a.stride + n] = 0;
          continue;
        }
        const float scale = __fmul_rn(xd, a.col_scale[l][n]);
        const int wz = static_cast<int>(a.col_zero[l][n]);
        const int corr =
            p.c[e] - xz * sw_e[e & 1] - wz * p.sx[e >> 1] + K * xz * wz;
        const float y =
            __fadd_rn(__fmul_rn(scale, __int2float_rn(corr)), a.bias[l][n]);
        if (last) {
          const int m = row0 + r;
          if (m < M) out[static_cast<size_t>(m) * N + n] = y;
        } else {
          float q = __fadd_rn(rintf(__fdiv_rn(fmaxf(y, 0.0f), nxd)), nxz);
          q = fminf(fmaxf(q, -128.0f), 127.0f);
          h_next[r * a.stride + n] = static_cast<int8_t>(static_cast<int>(q));
        }
      }
    }
    if (!last) {   // the next layer's K padding past the n8 tiles
      const int from = 8 * NT, to = (N + 31) & ~31;
      for (int i = tid; i < ROWS * (to - from); i += THREADS)
        h_next[(i / (to - from)) * a.stride + from + i % (to - from)] = 0;
    }
    cur ^= 1;
  }
}

}  // namespace

// Launches on `stream`; returns a cudaError_t value (0 on success).  The
// per-layer arrays are host arrays of n_layers entries; `staged` holds
// each layer's codes' byte offset in shared memory (a multiple of 16) or
// -1 to read them from global memory; `stride` is the activation row
// stride (a multiple of 32 plus 16, above every width), `red` the offset
// of WARPS * 32 * 7 ints of split-K partials, `kmajor` that of the K-major
// buffer (the widest staged layer's), `smem` the block's dynamic
// shared-memory bytes.
extern "C" int repro_fused_qmlp(const void* x, int M, int K0, int n_layers,
                                const void* const* codes,
                                const void* const* col_scale,
                                const void* const* col_zero,
                                const void* const* bias,
                                const void* const* x_delta,
                                const void* const* x_zero, const int* ks,
                                const int* ns, const int* bits,
                                const int* staged, int stride, int red,
                                int kmajor, int smem, void* out,
                                void* stream) {
  if (n_layers < 1 || n_layers > MAX_LAYERS || stride % 32 != 16 ||
      red % 16 != 0 || kmajor % 16 != 0 || smem > SMEM_LIMIT ||
      red + WARPS * 32 * 7 * 4 > smem || 2 * ROWS * stride > red)
    return static_cast<int>(cudaErrorInvalidValue);
  QMLPArgs a = {};
  for (int l = 0; l < n_layers; ++l) {
    a.codes[l] = static_cast<const int8_t*>(codes[l]);
    a.col_scale[l] = static_cast<const float*>(col_scale[l]);
    a.col_zero[l] = static_cast<const float*>(col_zero[l]);
    a.bias[l] = static_cast<const float*>(bias[l]);
    a.x_delta[l] = static_cast<const float*>(x_delta[l]);
    a.x_zero[l] = static_cast<const float*>(x_zero[l]);
    a.k[l] = ks[l];
    a.n[l] = ns[l];
    a.bits[l] = bits[l];
    a.staged[l] = staged[l];
    if (staged[l] >= 0 && staged[l] % 16 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  a.n_layers = n_layers;
  a.stride = stride;
  a.red = red;
  a.kmajor = kmajor;
  static bool configured = false;   // the attribute is per kernel, once
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_qmlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_LIMIT);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  fused_qmlp_kernel<<<(M + ROWS - 1) / ROWS, THREADS, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), M, K0, a, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
