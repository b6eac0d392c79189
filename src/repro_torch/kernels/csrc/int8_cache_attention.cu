// Kernel B3: single-token decode attention over an int8 KV cache with
// per-token scales, causal and window mask, for sm_90a.
//
// Replaces repro/kernels/int8_cache_attention.py:
// int8_cache_decode_attention (kernel _kernel).  For each of the G query
// rows q_g (Dh) of a problem (batch b, KV head h) with decode position
// p = pos[b, h]:
//   s_t  = (sum_d q_g[d] * (k_codes[b, h, t, d] * k_scale[b, h, t])) * Dh**-0.5
//   out  = sum_t softmax(s)_t * (v_codes[b, h, t, :] * v_scale[b, h, t])
// over the slots t in [max(0, p - window + 1), min(p, T - 1)] (no lower
// limit without a window).  The dense reference masks the other slots with
// -1e30, whose exp is exactly 0 in f32 once one slot is valid, so skipping
// them changes nothing but the order of the sums.  Contract: 0 <= p < T;
// a problem with no valid slot (p < 0) writes 0, as the TPU kernel does
// for a fully masked row.
//
// Bound on the H100: bytes.  Each valid slot costs 2 * Dh code bytes and
// 8 scale bytes against about 4 * G * Dh flops, below the ridge point of
// float32 on the CUDA cores (67 TFLOP/s against 3.35 TB/s: 20 flops a
// byte; here about 2 * G).  The cache is read where it lies: codes and
// scales are addressed by (batch, head, slot) strides, so the LM's
// (B, T, KV, Dh) cache is read in place and nothing is copied first.
//
// The first design (one block per query row, each warp walking one slot
// at a time) reached 0.5% of that bound at a long cache (8 problems, G 4,
// T 4096, Dh 128): 32 blocks on 132 SMs; each warp a dependent chain of
// one 1-byte load per lane, a shuffle reduction and two expf per slot,
// 512 slots in series, so load latency set the time; and the G query
// heads of a problem each read the same slots again.  This design has
// two paths (plan() in kernels/int8_cache_attention.py picks one):
//
// The split path, for more than SMALL slots:
//  * one block per (problem, key split), all G query heads in the block,
//    so each slot is read once per problem.  The split S fills the SMs
//    twice over where the slots are many (S = 8 at danube's 4,096-slot
//    ring with 32 problems, 32 at the 8-problem long cache);
//  * the split's slots stream through shared memory in tiles of TS slots
//    (K tiles, then V tiles), STAGES tiles in flight through cp.async:
//    16 bytes a thread, neighbouring threads on neighbouring bytes of
//    neighbouring slots, the K tile carrying both scales;
//  * two passes: the scores of the whole split into shared memory (LANES
//    lanes a slot, each a share of the row, q from shared memory); one
//    softmax over the split (its max, then exp and sum, threads over
//    (slot, head)); then weights times V, one thread per (4 columns, slot
//    subgroup) with G accumulators of 4 columns in registers.  No
//    running rescale, and a barrier per tile only;
//  * codes become floats by a byte permute and one exact subtraction
//    (2^23 + c + 128 - (2^23 + 128)), not the slow integer-to-float
//    conversion;
//  * with S > 1 every block writes its partial (m, l, acc) to a scratch
//    buffer and takes a ticket from the problem's arrival counter; the
//    last block to arrive merges the S partials (a split with no valid
//    slot, m = -inf and l = 0, adds nothing) and sets the counter back to
//    0, so one launch does the whole call.
// Measured on the H100 (tools/kernel_ablation.py) the products and the
// conversions on the CUDA cores, not the bytes, set the split path's
// time: taking out either product saves more than taking out the copies.
//
// The small path, for at most SMALL slots (the sequence actor's window
// of 8 or 6), where the launch and a few dependent loads set the time:
// the first design's short chain, one block a problem and one warp a
// slot, with the G heads of the problem one after the other.
//
// Numerics: expf (not __expf), correctly rounded division, and the
// library is built with -fmad=false and without --use_fast_math, so the
// compiler contracts nothing.  The split path's two inner products use
// __fmaf_rn, one rounding per term (as the GEMMs behind the plain version
// do); everything else is __fmul_rn / __fadd_rn.  The scale of a slot
// multiplies its dot product (and the softmax weight of its V row) once
// instead of each element.  The result matches the dense plain version
// within 1e-5, not bitwise: the sums run in another order.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TS = 128;       // slots a tile
constexpr int STAGES = 4;     // K or V tiles in the ring
constexpr int LANES = 2;      // lanes a slot in the q.k products
constexpr int MAX_DH = 256;
constexpr int MAX_G = 16;
constexpr int SMALL = 32;     // slots at most on the small path
constexpr unsigned FULL = 0xffffffffu;
static_assert(THREADS == TS * LANES, "one slot of a tile a lane group");

struct Args {
  const float* q;
  const int8_t* kc;
  const float* ks;
  const int8_t* vc;
  const float* vs;
  const int* pos;
  float* out;
  float* part;   // S > 1: (R, S, G, 4 * words(Dh)) sums, then (R, S, G)
                 // (m, l) pairs
  int* count;    // S > 1: (R,) arrival counters, 0 between launches
  int R, NH, G, T, Dh, window, S, per, vec;
  long long cb, ch, ct;   // code strides (bytes): batch, head, slot
  long long sb, sh, st;   // scale strides (floats)
  long long pb, ph;       // pos strides
  float scale;
};

__host__ __device__ inline int words(int Dh) { return (Dh + 3) / 4; }

// Words of a code row in shared memory: at least Dh / 4, and 4 times an
// odd number, so 8 neighbouring rows start in 8 different 4-bank groups
// (the q.k products read a column of words across the rows) and every
// row starts 16-byte aligned.
__host__ __device__ inline int row_words(int Dh) {
  const int w = words(Dh);
  return w + ((4 - w) % 8 + 8) % 8;
}

__host__ __device__ inline int cap(int per) { return (per + TS - 1) / TS * TS; }
__host__ __device__ inline int align16(int bytes) { return (bytes + 15) / 16 * 16; }

// The ring: stages of rows; a split of fewer slots than STAGES / 2 tiles
// gets only the stages and rows it streams.
__host__ __device__ inline int ring_rows(int per) { return per < TS ? per : TS; }
__host__ __device__ inline int ring_stages(int per) {
  const int n = 2 * (cap(per) / TS);
  return n < STAGES ? n : STAGES;
}

// Region 0 holds the ring during the tiles; after them, the subgroups'
// partial sums; then the merge's float4 sums and l.
__host__ __device__ inline int region0_bytes(int G, int Dh, int per, int S) {
  const int ring = ring_stages(per) * ring_rows(per) * 4 * row_words(Dh);
  const int red = (THREADS / words(Dh)) * G * 4 * words(Dh) * 4;
  const int nc4 = G * words(Dh) > THREADS ? G * words(Dh) : THREADS;
  const int merge = S > 1 ? 20 * nc4 : 0;   // float4 sums and l
  const int m = ring > red ? ring : red;
  return align16(m > merge ? m : merge);
}

__host__ __device__ inline int smem_bytes(int G, int GM, int Dh, int per,
                                          int S) {
  return region0_bytes(G, Dh, per, S) +
         4 * (2 * cap(per) + cap(per) * GM + G * 4 * words(Dh) +
              2 * WARPS * MAX_G + 2 * MAX_G);
}

__host__ __device__ inline bool small_path(int per, int S) {
  return S == 1 && per <= SMALL;
}

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}

// Four int8 codes of a 32-bit word as exact floats.
__device__ __forceinline__ void unpack(uint32_t x, float* f) {
  x ^= 0x80808080u;   // c -> c + 128 in each byte
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __fsub_rn(__uint_as_float(__byte_perm(x, 0x4B000000u, 0x7540 | i)),
                     8388736.0f);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void copy_piece(void* dst, const void* src,
                                           int vec) {
  switch (vec) {
    case 16:
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       smem_addr(dst)),
                   "l"(src));
      break;
    case 8:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                       smem_addr(dst)),
                   "l"(src));
      break;
    case 4:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                       smem_addr(dst)),
                   "l"(src));
      break;
    default:   // unaligned codes: a plain byte copy, seen after the barrier
      *static_cast<int8_t*>(dst) = *static_cast<const int8_t*>(src);
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Block-wide reduction of one value per head: thread tid holds head
// tid % GM; returns the head's result to every thread of it.  `buf` has
// WARPS * MAX_G floats.
template <int GM, bool MAX>
__device__ __forceinline__ float head_reduce(float v, float* buf) {
#pragma unroll
  for (int off = GM; off < 32; off <<= 1) {
    const float o = __shfl_xor_sync(FULL, v, off);
    v = MAX ? fmaxf(v, o) : add(v, o);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane < GM) buf[warp * MAX_G + lane] = v;
  __syncthreads();
  const int g = threadIdx.x % GM;
  float r = buf[g];
  for (int w = 1; w < WARPS; ++w)
    r = MAX ? fmaxf(r, buf[w * MAX_G + g]) : add(r, buf[w * MAX_G + g]);
  return r;
}

// The split path: one block a (problem, split).
template <int GM>
__global__ void __launch_bounds__(THREADS, 4)   // 4 blocks an SM: 64 regs
int8_cache_attention_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last_block;

  const int G = a.G, Dh = a.Dh, S = a.S;
  const int W = words(Dh), W4 = 4 * W, RB = 4 * row_words(Dh);
  const int CAP = cap(a.per), SB = ring_rows(a.per) * RB;  // stage bytes
  unsigned char* ring = smem;
  float* ks_s =   // the split's scales
      reinterpret_cast<float*>(smem + region0_bytes(G, Dh, a.per, S));
  float* vs_s = ks_s + CAP;
  float* w_s = vs_s + CAP;      // (CAP, GM): scores, then weights
  float* q_s = w_s + CAP * GM;  // (G, W4), zero past Dh
  float* buf = q_s + G * W4;    // (2, WARPS, MAX_G) head reductions
  float* mx_s = buf + 2 * WARPS * MAX_G;   // (MAX_G) the split's max
  float* l_s = mx_s + MAX_G;               // (MAX_G) and sum

  const int tid = threadIdx.x;
  const int r = blockIdx.x / S, c = blockIdx.x - r * S;
  const int b = r / a.NH, h = r - b * a.NH;
  const int p = a.pos[b * a.pb + h * a.ph];
  const int hi = min(p, a.T - 1);
  const int lo = a.window > 0 ? max(0, p - a.window + 1) : 0;
  const int first = lo + c * a.per;   // this split's slots: [first, last]
  const int n = max(0, min(hi, first + a.per - 1) - first + 1);
  const int tiles = (n + TS - 1) / TS;

  const int8_t* kbase = a.kc + b * a.cb + h * a.ch + first * a.ct;
  const int8_t* vbase = a.vc + b * a.cb + h * a.ch + first * a.ct;
  const float* ksbase = a.ks + b * a.sb + h * a.sh + first * a.st;
  const float* vsbase = a.vs + b * a.sb + h * a.sh + first * a.st;
  const int npc = Dh / a.vec;   // cp.async pieces a code row

  // The ring streams K tiles 0 .. tiles - 1 (with both scales), then V
  // tiles 0 .. tiles - 1: stream item k into stage k % STAGES (below
  // ring_stages(per), which is 2 * tiles or more where it is < STAGES).
  auto load = [&](int k) {
    if (k < 2 * tiles) {
      const int v = k >= tiles, tile = k - v * tiles;
      const int t0 = tile * TS, nt = min(TS, n - t0);
      const int8_t* src = (v ? vbase : kbase) + t0 * a.ct;
      unsigned char* dst = ring + (k % STAGES) * SB;
      for (int i = tid; i < nt * npc; i += THREADS) {
        const int row = i / npc, pc = i - row * npc;
        copy_piece(dst + row * RB + pc * a.vec, src + row * a.ct + pc * a.vec,
                   a.vec);
      }
      if (!v) {
        for (int i = tid; i < 2 * nt; i += THREADS) {
          const int which = i >= nt, row = i - which * nt;
          copy_piece((which ? vs_s : ks_s) + t0 + row,
                     (which ? vsbase : ksbase) + (t0 + row) * a.st, 4);
        }
      }
    }
    cp_commit();
  };

  // q first: loads issued after the ring's would queue behind them
  for (int i = tid; i < G * W4; i += THREADS) {
    const int g = i / W4, d = i - g * W4;
    q_s[i] = d < Dh ? a.q[(static_cast<size_t>(r) * G + g) * Dh + d] : 0.0f;
  }
  for (int k = 0; k < STAGES - 1; ++k) load(k);

  // pass 1, scores: lane group tid / LANES takes one slot of the tile,
  // its LANES lanes the row's words j, j + LANES, ...
  const int qt = tid / LANES, qj = tid % LANES;
  for (int k = 0; k < tiles; ++k) {
    const int t = k * TS + qt;
    const bool mine = qt < min(TS, n - k * TS);
    cp_wait<STAGES - 2>();
    __syncthreads();   // tile k landed; the stage read at k - 1 is free
    load(k + STAGES - 1);
    const uint32_t* row = reinterpret_cast<const uint32_t*>(
        ring + (k % STAGES) * SB + qt * RB);
    float dot[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) dot[g] = 0.0f;
    if (mine) {
#pragma unroll 4
      for (int w = qj; w < W; w += LANES) {
        float kf[4];
        unpack(row[w], kf);
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          if (g < G) {
            const float4 qv =
                *reinterpret_cast<const float4*>(q_s + g * W4 + 4 * w);
            dot[g] = __fmaf_rn(qv.x, kf[0], dot[g]);
            dot[g] = __fmaf_rn(qv.y, kf[1], dot[g]);
            dot[g] = __fmaf_rn(qv.z, kf[2], dot[g]);
            dot[g] = __fmaf_rn(qv.w, kf[3], dot[g]);
          }
        }
      }
    }
#pragma unroll
    for (int g = 0; g < GM; ++g) {
#pragma unroll
      for (int off = LANES / 2; off > 0; off >>= 1)
        dot[g] = add(dot[g], __shfl_xor_sync(FULL, dot[g], off));
    }
    if (mine) {
      const float f = mul(ks_s[t], a.scale);
#pragma unroll
      for (int g = 0; g < GM; ++g)
        if (g < G && g % LANES == qj) w_s[t * GM + g] = mul(dot[g], f);
    }
  }
  __syncthreads();

  // the split's softmax: thread tid takes head tid % GM of every
  // (THREADS / GM)-th slot; the weights e^(s - max) * v_scale replace
  // the scores
  {
    const int g = tid % GM;
    float mx = -INFINITY;
    if (g < G)
      for (int t = tid / GM; t < n; t += THREADS / GM)
        mx = fmaxf(mx, w_s[t * GM + g]);
    mx = head_reduce<GM, true>(mx, buf);
    float sum = 0.0f;
    if (g < G)
      for (int t = tid / GM; t < n; t += THREADS / GM) {
        const float e = expf(w_s[t * GM + g] - mx);   // n >= 1 here
        sum = add(sum, e);
        w_s[t * GM + g] = mul(e, vs_s[t]);
      }
    sum = head_reduce<GM, false>(sum, buf + WARPS * MAX_G);
    if (tid < G) {
      mx_s[tid] = mx;
      l_s[tid] = sum;
    }
  }

  // pass 2, weights times V: thread (column word wd, slot subgroup sg)
  const int nsub = THREADS / W;
  const int wd = tid % W, sg = tid / W;
  float acc[GM][4];
#pragma unroll
  for (int g = 0; g < GM; ++g)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[g][e] = 0.0f;
  for (int k = tiles; k < 2 * tiles; ++k) {
    cp_wait<STAGES - 2>();
    __syncthreads();   // V tile landed, and (at the first) the weights
    load(k + STAGES - 1);
    const int t0 = (k - tiles) * TS, nt = min(TS, n - t0);
    const unsigned char* vt = ring + (k % STAGES) * SB;
    if (sg < nsub) {
#pragma unroll 2
      for (int t = sg; t < nt; t += nsub) {
        float vf[4];
        unpack(reinterpret_cast<const uint32_t*>(vt + t * RB)[wd], vf);
        float wt[GM];
        if (GM >= 4) {
#pragma unroll
          for (int g = 0; g < GM; g += 4)
            *reinterpret_cast<float4*>(wt + g) =
                *reinterpret_cast<const float4*>(w_s + (t0 + t) * GM + g);
        } else {
#pragma unroll
          for (int g = 0; g < GM; ++g) wt[g] = w_s[(t0 + t) * GM + g];
        }
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          if (g < G) {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[g][e] = __fmaf_rn(wt[g], vf[e], acc[g][e]);
          }
        }
      }
    }
  }

  cp_wait<0>();
  __syncthreads();   // the ring is free: region 0 takes the partial sums
  float* red = reinterpret_cast<float*>(smem);   // (nsub, G, W4)
  const int used = min(nsub, n);                 // subgroups with slots
  if (sg < used) {
#pragma unroll
    for (int g = 0; g < GM; ++g)
      if (g < G)
        *reinterpret_cast<float4*>(red + (sg * G + g) * W4 + 4 * wd) =
            make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
  }
  __syncthreads();
  // the split's sums over its subgroups, (G, W4); columns past Dh pad
  float* rec = a.part + (static_cast<size_t>(r) * S + c) * G * W4;
  for (int i = tid; i < G * W4; i += THREADS) {
    const int g = i / W4, d = i - g * W4;
    float sum = 0.0f;
    for (int u = 0; u < used; ++u) sum = add(sum, red[(u * G + g) * W4 + d]);
    if (S > 1) {
      rec[i] = sum;
    } else if (d < Dh) {
      const float l = l_s[g];
      a.out[(static_cast<size_t>(r) * G + g) * Dh + d] =
          l > 0.0f ? __fdiv_rn(sum, l) : 0.0f;
    }
  }
  if (S == 1) return;

  // merge: the last split of the problem to arrive sums the S partials
  float* ml = a.part + static_cast<size_t>(a.R) * S * G * W4 +
              static_cast<size_t>(r) * S * G * 2;
  if (tid < G) {
    ml[(c * G + tid) * 2] = mx_s[tid];
    ml[(c * G + tid) * 2 + 1] = l_s[tid];
  }
  __syncthreads();
  if (tid == 0) {   // release the block's partial, take a ticket, acquire
    __threadfence();
    last_block = atomicAdd(a.count + r, 1) == S - 1;
    __threadfence();
  }
  __syncthreads();
  if (!last_block) return;
  // float4 column c4 of the (G, W4) sums: tpc threads each take every
  // tpc-th split; every thread also reads the S (m, l) pairs of its head,
  // all loads in flight together, and keeps its own factors
  const int nc4 = G * W, tpc = nc4 < THREADS ? THREADS / nc4 : 1;
  const float4* accs = reinterpret_cast<const float4*>(a.part) +
                       static_cast<size_t>(r) * S * nc4;
  const float2* mls = reinterpret_cast<const float2*>(ml);
  float4* comb = reinterpret_cast<float4*>(smem);   // (tpc, nc4) sums
  float* comb_l = reinterpret_cast<float*>(comb + nc4 * tpc);   // and l
  for (int i = tid; i < nc4 * tpc; i += THREADS) {
    const int j = i / nc4, c4 = i - j * nc4, g = c4 / W;
    float mx = -INFINITY;
    for (int u = 0; u < S; ++u) {
      const float2 pu = __ldcg(mls + u * G + g);
      if (pu.y > 0.0f) mx = fmaxf(mx, pu.x);
    }
    float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float l = 0.0f;
#pragma unroll 4
    for (int u = j; u < S; u += tpc) {
      const float4 x = __ldcg(accs + static_cast<size_t>(u) * nc4 + c4);
      const float2 pu = __ldcg(mls + u * G + g);   // a split with no slot
      const float f = pu.y > 0.0f ? expf(pu.x - mx) : 0.0f;   // adds 0
      l = add(l, mul(pu.y, f));
      sum = make_float4(add(sum.x, mul(x.x, f)), add(sum.y, mul(x.y, f)),
                        add(sum.z, mul(x.z, f)), add(sum.w, mul(x.w, f)));
    }
    comb[i] = sum;
    comb_l[i] = l;
  }
  __syncthreads();
  for (int c4 = tid; c4 < nc4; c4 += THREADS) {
    float4 sum = comb[c4];
    float l = comb_l[c4];
    for (int j = 1; j < tpc; ++j) {
      const float4 x = comb[j * nc4 + c4];
      sum = make_float4(add(sum.x, x.x), add(sum.y, x.y), add(sum.z, x.z),
                        add(sum.w, x.w));
      l = add(l, comb_l[j * nc4 + c4]);
    }
    const int g = c4 / W, d0 = 4 * (c4 - g * W);
    const float v[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (d0 + e < Dh)
        a.out[(static_cast<size_t>(r) * G + g) * Dh + d0 + e] =
            l > 0.0f ? __fdiv_rn(v[e], l) : 0.0f;
  }
  if (tid == 0) a.count[r] = 0;   // ready for the next launch
}

// The small path, for a problem of at most SMALL slots (the sequence
// actor's window of 8 or 6): latency, not bytes, sets its time, so it
// keeps the first design's short chain of dependent loads.  One block a
// problem; its G query heads one after the other (the window's rows stay
// in L1 after the first).  Warp w takes slots lo + w, lo + w + WARPS,
// ...: lane j holds elements j, j + 32, ... of q, dequantizes the K row
// in registers, reduces the dot product with xor shuffles and keeps its
// own online softmax; the WARPS partial states are merged through shared
// memory.
template <int EPL>
__global__ void __launch_bounds__(THREADS)
int8_cache_attention_small_kernel(const Args a) {
  __shared__ float sm_m[WARPS];
  __shared__ float sm_l[WARPS];
  __shared__ float sm_acc[WARPS][MAX_DH];

  const int r = blockIdx.x, G = a.G, Dh = a.Dh;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = r / a.NH, h = r - b * a.NH;
  // read-only loads (ld.global.nc): the inputs never alias the output
  const int p = __ldg(a.pos + b * a.pb + h * a.ph);
  const int hi = min(p, a.T - 1);
  const int lo = a.window > 0 ? max(0, p - a.window + 1) : 0;
  const int8_t* kbase = a.kc + b * a.cb + h * a.ch;
  const int8_t* vbase = a.vc + b * a.cb + h * a.ch;
  const float* ksbase = a.ks + b * a.sb + h * a.sh;
  const float* vsbase = a.vs + b * a.sb + h * a.sh;

  for (int g = 0; g < G; ++g) {
    const size_t row = static_cast<size_t>(r) * G + g;
    float qv[EPL];
    float acc[EPL];
#pragma unroll
    for (int i = 0; i < EPL; ++i) {
      const int d = lane + 32 * i;
      qv[i] = d < Dh ? __ldg(a.q + row * Dh + d) : 0.0f;
      acc[i] = 0.0f;
    }
    float m = -INFINITY;
    float l = 0.0f;
    for (int t = lo + warp; t <= hi; t += WARPS) {
      const int8_t* krow = kbase + t * a.ct;
      const int8_t* vrow = vbase + t * a.ct;
      const float ksc = __ldg(ksbase + t * a.st);
      const float vsc = __ldg(vsbase + t * a.st);
      float dot = 0.0f;
#pragma unroll
      for (int i = 0; i < EPL; ++i) {
        const int d = lane + 32 * i;
        if (d < Dh) {
          const float k = mul(static_cast<float>(__ldg(krow + d)), ksc);
          dot = add(dot, mul(qv[i], k));
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        dot = add(dot, __shfl_xor_sync(FULL, dot, off));
      const float s = mul(dot, a.scale);
      const float m_new = fmaxf(m, s);
      const float alpha = expf(m - m_new);  // 0 on the first slot (m = -inf)
      const float e = expf(s - m_new);
      l = add(mul(l, alpha), e);
#pragma unroll
      for (int i = 0; i < EPL; ++i) {
        const int d = lane + 32 * i;
        if (d < Dh) {
          const float v = mul(static_cast<float>(__ldg(vrow + d)), vsc);
          acc[i] = add(mul(acc[i], alpha), mul(e, v));
        }
      }
      m = m_new;
    }

    if (lane == 0) {
      sm_m[warp] = m;
      sm_l[warp] = l;
    }
#pragma unroll
    for (int i = 0; i < EPL; ++i) {
      const int d = lane + 32 * i;
      if (d < Dh) sm_acc[warp][d] = acc[i];
    }
    __syncthreads();
    for (int d = threadIdx.x; d < Dh; d += THREADS) {
      float mx = -INFINITY;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, sm_m[w]);
      float lsum = 0.0f;
      float o = 0.0f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        if (sm_l[w] > 0.0f) {   // a warp with no slot adds nothing
          const float f = expf(sm_m[w] - mx);
          lsum = add(lsum, mul(sm_l[w], f));
          o = add(o, mul(sm_acc[w][d], f));
        }
      }
      a.out[row * Dh + d] = lsum > 0.0f ? __fdiv_rn(o, lsum) : 0.0f;
    }
    if (g + 1 < G) __syncthreads();   // the shared state is free again
  }
}

// The split kernel's attributes for `bytes` of dynamic shared memory:
// the SM's largest carveout, so several blocks of a split share it, and
// the opt-in above 48 KB.
template <int GM>
int launch_config(int bytes) {
  static int configured = 0;   // the attributes are per kernel
  if (configured == 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        int8_cache_attention_kernel<GM>,
        cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = 48 * 1024;
  }
  if (bytes > configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        int8_cache_attention_kernel<GM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = bytes;
  }
  return 0;
}

template <int GM>
int launch(const Args& a, cudaStream_t stream) {
  const int bytes = smem_bytes(a.G, GM, a.Dh, a.per, a.S);
  const int err = launch_config<GM>(bytes);
  if (err) return err;
  int8_cache_attention_kernel<GM><<<a.R * a.S, THREADS, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int EPL>
int launch_small(const Args& a, cudaStream_t stream) {
  int8_cache_attention_small_kernel<EPL><<<a.R, THREADS, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int g_max(int G) {
  for (int gm = 1; gm < MAX_G; gm *= 2)
    if (G <= gm) return gm;
  return MAX_G;
}

}  // namespace

// Dynamic shared-memory bytes of a block for G query heads of head dim
// Dh, splits of `per` slots, S splits (kernels/int8_cache_attention.py:
// plan mirrors it; a test holds the two equal on the card).  The small
// path has static shared memory only: 0.
extern "C" int repro_int8_cache_attention_smem(int G, int Dh, int per, int S) {
  return small_path(per, S) ? 0 : smem_bytes(G, g_max(G), Dh, per, S);
}

// q (NB, NH, G, Dh) f32 contiguous; codes int8 and scales f32 addressed
// as base + b * cb + h * ch + t * ct (+ d, unit stride) and base + b * sb
// + h * sh + t * st; pos int32 at b * pb + h * ph; out (NB, NH, G, Dh) f32
// contiguous.  S splits of `per` slots from plan(); with S > 1, part
// holds NB * NH * S * G * (2 + 4 * ceil(Dh / 4)) floats and count NB * NH
// int32 zeros (left zero again).  vec (16, 8, 4 or 1) divides Dh, the code
// strides and the code pointers.  window <= 0 means none.  Launches on
// `stream` and returns cudaGetLastError() (0 on success); a shape it does
// not take returns cudaErrorInvalidValue without launching.
extern "C" int repro_int8_cache_attention(
    const void* q, const void* kc, const void* ks, const void* vc,
    const void* vs, const void* pos, void* out, void* part, void* count,
    int NB, int NH, int G, int T, int Dh, int window, int S, int per, int vec,
    long long cb, long long ch, long long ct, long long sb, long long sh,
    long long st, long long pb, long long ph, float scale, void* stream) {
  const long long n_max = window > 0 && window < T ? window : T;
  const long long blocks = static_cast<long long>(NB) * NH * S;
  if (NB < 1 || NH < 1 || G < 1 || G > MAX_G || T < 1 || Dh < 1 ||
      Dh > MAX_DH || S < 1 || per < 1 ||
      static_cast<long long>(S) * per < n_max || blocks > 0x7fffffffLL ||
      !(vec == 1 || vec == 4 || vec == 8 || vec == 16) || Dh % vec != 0 ||
      (S > 1 && (part == nullptr || count == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(q),  static_cast<const int8_t*>(kc),
               static_cast<const float*>(ks), static_cast<const int8_t*>(vc),
               static_cast<const float*>(vs), static_cast<const int*>(pos),
               static_cast<float*>(out),      static_cast<float*>(part),
               static_cast<int*>(count),      NB * NH, NH, G, T, Dh, window,
               S, per, vec, cb, ch, ct, sb, sh, st, pb, ph, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (small_path(per, S)) {
    if (Dh <= 32) return launch_small<1>(a, s);
    if (Dh <= 64) return launch_small<2>(a, s);
    if (Dh <= 128) return launch_small<4>(a, s);
    return launch_small<8>(a, s);
  }
  switch (g_max(G)) {
    case 1: return launch<1>(a, s);
    case 2: return launch<2>(a, s);
    case 4: return launch<4>(a, s);
    case 8: return launch<8>(a, s);
    default: return launch<16>(a, s);
  }
}
