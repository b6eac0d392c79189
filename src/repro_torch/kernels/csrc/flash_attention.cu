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
// Bound on the H100: float32 operations.  At the prefill shapes (S = T =
// 8192, D 80 or 256) each unmasked (query, key) pair costs 4 * D flops
// (two FMAs a dimension, for q.k and p.v) against 8 * D bytes of K and V
// that every query tile shares, far above the ridge point of 67 TFLOP/s
// over 3.35 TB/s.  The tensor cores cannot take float32: TF32 keeps 10
// mantissa bits, which the 1e-5 contract with the dense oracle does not
// allow.  So this kernel runs on the FMA pipes and keeps them fed from
// shared memory: each thread computes a 4 x 4 tile of logits and a 4 x
// NC tile of the output in registers, reading q and k as float4s.
//
// Layout: one block of 256 threads per (64-query tile, head, batch), all
// in one grid; the tiles with the most keys (the last ones, under a
// causal mask) launch first.  The q tile stays in shared memory for the
// whole block; K and V are staged through shared memory 64 keys at a
// time.  Thread (rg, cg) = (tid / 16, tid % 16) owns query rows 4rg ..
// 4rg + 3, logit columns cg + 16 jj and output columns cg + 16 c.  A
// row's 16 threads are one half-warp, so the row max and sum are xor
// shuffles (bitwise the same in every lane).  The online softmax keeps
// (m, l, acc) in registers; a key tile that lies wholly outside
// [q_lo - window + 1, q_hi] is skipped, which changes nothing but the
// order of the sums.  Masked logits are -inf; a row whose max is still
// -inf exponentiates against 0, so its p and alpha are 0.
//
// Numerics: expf (not __expf), tanhf and correctly rounded division; the
// library is built with -fmad=false, and the dot products use explicit
// fmaf.  The result matches the dense plain version within 1e-5, not
// bitwise: the sums run in another order.
//
// The next design (a later PR): wgmma tiles fed by TMA copies of K and V
// through an mbarrier ring, with a warp-specialised producer, either in
// TF32 with the 3xTF32 split (to hold 1e-5) or in bf16 once the LM path
// takes bf16 inputs.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per staged tile
constexpr int THREADS = 256;  // 16 row groups x 16 column groups
constexpr int MAX_D = 256;
constexpr unsigned FULL = 0xffffffffu;

template <int NC>
constexpr int smem_floats() {
  // q (BQ x QS), k (BK x QS), v (BK x DP), p (BQ x PS)
  return BQ * (16 * NC + 4) + BK * (16 * NC + 4) + BK * 16 * NC +
         BQ * (BK + 4);
}

// NC output columns per thread: the head dim padded to DP = 16 * NC
template <int NC>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       int S, int T, int H, int KV, int D, int causal,
                       int window, float softcap, float scale) {
  constexpr int DP = 16 * NC;
  constexpr int QS = DP + 4;  // row stride of q and k: float4 reads of k
                              // rows cg + 16 jj hit distinct banks
  constexpr int PS = BK + 4;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BQ * QS;
  float* Vs = Ks + BK * QS;
  float* Ps = Vs + BK * DP;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int rg = tid >> 4;
  const int cg = tid & 15;
  const int i0 = qt * BQ;
  const int off = T - S;

  const size_t q_row = static_cast<size_t>(H) * D;
  const float* qb = q + static_cast<size_t>(b) * S * q_row +
                    static_cast<size_t>(h) * D;
  for (int idx = tid; idx < BQ * DP; idx += THREADS) {
    const int r = idx / DP;
    const int d = idx - r * DP;
    const int i = i0 + r;
    Qs[r * QS + d] = (i < S && d < D) ? qb[i * q_row + d] : 0.0f;
  }

  // the keys some query of this tile can see
  const int qp_lo = i0 + off;
  const int qp_hi = min(i0 + BQ, S) - 1 + off;
  const int k_hi = causal ? min(T - 1, qp_hi) : T - 1;
  const int k_lo = window > 0 ? max(0, qp_lo - window + 1) : 0;

  float acc[4][NC];
  float m[4];
  float l[4];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    m[ii] = -INFINITY;
    l[ii] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[ii][c] = 0.0f;
  }

  const size_t kv_row = static_cast<size_t>(KV) * D;
  const size_t kv_base = static_cast<size_t>(b) * T * kv_row +
                         static_cast<size_t>(kvh) * D;
  const float* kb = k + kv_base;
  const float* vb = v + kv_base;

  for (int j0 = (k_lo / BK) * BK; j0 <= k_hi; j0 += BK) {
    __syncthreads();  // the last tile's reads of Ks, Vs and Ps are done
    for (int idx = tid; idx < BK * DP; idx += THREADS) {
      const int j = idx / DP;
      const int d = idx - j * DP;
      const int t = j0 + j;
      const bool in = t < T && d < D;
      Ks[j * QS + d] = in ? kb[t * kv_row + d] : 0.0f;
      Vs[j * DP + d] = in ? vb[t * kv_row + d] : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[ii][jj] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < DP; d += 4) {
      float4 qv[4];
      float4 kv[4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
        qv[ii] = *reinterpret_cast<const float4*>(&Qs[(4 * rg + ii) * QS + d]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        kv[jj] = *reinterpret_cast<const float4*>(&Ks[(cg + 16 * jj) * QS + d]);
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          float a = s[ii][jj];
          a = fmaf(qv[ii].x, kv[jj].x, a);
          a = fmaf(qv[ii].y, kv[jj].y, a);
          a = fmaf(qv[ii].z, kv[jj].z, a);
          a = fmaf(qv[ii].w, kv[jj].w, a);
          s[ii][jj] = a;
        }
    }

#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int qp = i0 + 4 * rg + ii + off;
      float mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int t = j0 + cg + 16 * jj;
        float x = __fmul_rn(s[ii][jj], scale);
        if (softcap > 0.0f) x = __fmul_rn(softcap, tanhf(x / softcap));
        const bool ok = t < T && (!causal || t <= qp) &&
                        (window <= 0 || t > qp - window);
        x = ok ? x : -INFINITY;
        s[ii][jj] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
      const float m_new = fmaxf(m[ii], mx);
      const float m_use = m_new == -INFINITY ? 0.0f : m_new;
      const float alpha = expf(m[ii] - m_use);  // 0 while m is -inf
      float rs = 0.0f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = expf(s[ii][jj] - m_use);
        s[ii][jj] = p;
        rs = __fadd_rn(rs, p);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        rs = __fadd_rn(rs, __shfl_xor_sync(FULL, rs, o));
      l[ii] = __fadd_rn(__fmul_rn(l[ii], alpha), rs);
      m[ii] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[ii][c] = __fmul_rn(acc[ii][c], alpha);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        Ps[(4 * rg + ii) * PS + cg + 16 * jj] = s[ii][jj];
    }
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float4 pv[4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
        pv[ii] = *reinterpret_cast<const float4*>(&Ps[(4 * rg + ii) * PS + j]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float vr[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) vr[c] = Vs[(j + jj) * DP + cg + 16 * c];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          const float p = jj == 0   ? pv[ii].x
                          : jj == 1 ? pv[ii].y
                          : jj == 2 ? pv[ii].z
                                    : pv[ii].w;
#pragma unroll
          for (int c = 0; c < NC; ++c) acc[ii][c] = fmaf(p, vr[c], acc[ii][c]);
        }
      }
    }
  }

  float* ob = out + static_cast<size_t>(b) * S * q_row +
              static_cast<size_t>(h) * D;
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int i = i0 + 4 * rg + ii;
    if (i >= S) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = cg + 16 * c;
      if (d < D)
        ob[i * q_row + d] = l[ii] > 0.0f ? acc[ii][c] / l[ii] : 0.0f;
    }
  }
}

template <int NC>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int T, int H, int KV, int D, int causal, int window,
           float softcap, float scale, cudaStream_t stream) {
  constexpr size_t bytes = sizeof(float) * smem_floats<NC>();
  static bool configured = false;  // the attribute is per kernel, once
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<NC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_attention_kernel<NC><<<grid, THREADS, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), S, T, H, KV, D,
      causal, window, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, S, H, D), k and v (B, T, KV, D), out (B, S, H, D): contiguous
// float32 on the device.  H must be a multiple of KV; window <= 0 means
// none, softcap <= 0 means none.  Launches on `stream` and returns the
// launch's cudaError_t (0 on success); a shape it does not take returns
// cudaErrorInvalidValue without launching.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int B, int S,
                                     int T, int H, int KV, int D, int causal,
                                     int window, float softcap, float scale,
                                     void* stream) {
  if (B < 1 || S < 1 || T < 1 || KV < 1 || H < KV || H % KV != 0 || D < 1 ||
      D > MAX_D || H > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nc = (D + 15) / 16;
  if (nc <= 2)
    return launch<2>(q, k, v, out, B, S, T, H, KV, D, causal, window, softcap,
                     scale, st);
  if (nc <= 4)
    return launch<4>(q, k, v, out, B, S, T, H, KV, D, causal, window, softcap,
                     scale, st);
  if (nc <= 5)
    return launch<5>(q, k, v, out, B, S, T, H, KV, D, causal, window, softcap,
                     scale, st);
  if (nc <= 8)
    return launch<8>(q, k, v, out, B, S, T, H, KV, D, causal, window, softcap,
                     scale, st);
  if (nc <= 12)
    return launch<12>(q, k, v, out, B, S, T, H, KV, D, causal, window,
                      softcap, scale, st);
  return launch<16>(q, k, v, out, B, S, T, H, KV, D, causal, window, softcap,
                    scale, st);
}
