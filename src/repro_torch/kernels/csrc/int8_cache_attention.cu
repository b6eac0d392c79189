// Kernel B3: single-token decode attention over an int8 KV cache with
// per-token scales, causal and window mask, for sm_90a.
//
// Replaces repro/kernels/int8_cache_attention.py:
// int8_cache_decode_attention (kernel _kernel).  For each query row q (Dh)
// of a problem r with decode position p = pos[r]:
//   s_t  = (sum_d q[d] * (k_codes[r, t, d] * k_scale[r, t])) * Dh**-0.5
//   out  = sum_t softmax(s)_t * (v_codes[r, t, :] * v_scale[r, t])
// over the slots t in [max(0, p - window + 1), min(p, T - 1)] (no lower
// limit without a window).  The dense reference masks the other slots with
// -1e30, whose exp is exactly 0 in f32 once one slot is valid, so skipping
// them changes nothing but the order of the sums.  Contract: 0 <= p < T;
// a row with no valid slot (p < 0) writes 0, as the TPU kernel does for a
// fully masked row.
//
// Bound on the H100: bytes.  Each valid slot costs 2 * Dh code bytes and
// 8 scale bytes against about 4 * Dh flops, far below the ridge point.
// The TPU kernel walked every T block in order with its online-softmax
// state in VMEM scratch; here only the window's slots are read, so at the
// sequence actor's shape (512 rows, window 8 of 121 slots, Dh 32) the
// kernel reads about a fifteenth of the cache.  Launch latency sets its
// time there.
//
// Layout: one block of WARPS warps per query row (flattened batch x G on
// the grid).  Each lane holds EPL = ceil(Dh / 32) elements of q, and of
// the output accumulator, in registers (d = lane + 32 * i, so a warp reads
// a slot's code row in 32-byte sectors).  Warp w takes slots lo + w,
// lo + w + WARPS, ...: it dequantizes the K row in registers, reduces the
// dot product with xor shuffles, and keeps its own online softmax (max m,
// sum l, acc).  The WARPS partial states are merged through shared memory
// at the end: out[d] = sum_w acc_w[d] e^(m_w - M) / sum_w l_w e^(m_w - M).
//
// Numerics: expf (not __expf), correctly rounded division, and the
// library is built with -fmad=false and without --use_fast_math.  The
// result matches the dense plain version within 1e-5, not bitwise: the
// online softmax and the shuffle tree sum in another order.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_DH = 256;
constexpr unsigned FULL = 0xffffffffu;

template <int EPL>
__global__ void __launch_bounds__(THREADS)
int8_cache_attention_kernel(const float* __restrict__ q,
                            const int8_t* __restrict__ k_codes,
                            const float* __restrict__ k_scale,
                            const int8_t* __restrict__ v_codes,
                            const float* __restrict__ v_scale,
                            const int* __restrict__ pos,
                            float* __restrict__ out, int G, int T, int Dh,
                            int window, float scale) {
  __shared__ float sm_m[WARPS];
  __shared__ float sm_l[WARPS];
  __shared__ float sm_acc[WARPS][MAX_DH];

  const int row = blockIdx.x;  // problem r, query g: row = r * G + g
  const int r = row / G;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int p = pos[r];
  const int hi = min(p, T - 1);
  const int lo = window > 0 ? max(0, p - window + 1) : 0;

  float qv[EPL];
  float acc[EPL];
#pragma unroll
  for (int i = 0; i < EPL; ++i) {
    const int d = lane + 32 * i;
    qv[i] = d < Dh ? q[static_cast<size_t>(row) * Dh + d] : 0.0f;
    acc[i] = 0.0f;
  }
  float m = -INFINITY;
  float l = 0.0f;

  const size_t base = static_cast<size_t>(r) * T;
  for (int t = lo + warp; t <= hi; t += WARPS) {
    const int8_t* krow = k_codes + (base + t) * Dh;
    const int8_t* vrow = v_codes + (base + t) * Dh;
    const float ksc = k_scale[base + t];
    const float vsc = v_scale[base + t];
    float dot = 0.0f;
#pragma unroll
    for (int i = 0; i < EPL; ++i) {
      const int d = lane + 32 * i;
      if (d < Dh) {
        const float k = __fmul_rn(static_cast<float>(krow[d]), ksc);
        dot = __fadd_rn(dot, __fmul_rn(qv[i], k));
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      dot = __fadd_rn(dot, __shfl_xor_sync(FULL, dot, off));
    const float s = __fmul_rn(dot, scale);
    const float m_new = fmaxf(m, s);
    const float alpha = expf(m - m_new);  // 0 on the first slot (m = -inf)
    const float e = expf(s - m_new);
    l = __fadd_rn(__fmul_rn(l, alpha), e);
#pragma unroll
    for (int i = 0; i < EPL; ++i) {
      const int d = lane + 32 * i;
      if (d < Dh) {
        const float v = __fmul_rn(static_cast<float>(vrow[d]), vsc);
        acc[i] = __fadd_rn(__fmul_rn(acc[i], alpha), __fmul_rn(e, v));
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
    float a = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      if (sm_l[w] > 0.0f) {
        const float f = expf(sm_m[w] - mx);
        lsum = __fadd_rn(lsum, __fmul_rn(sm_l[w], f));
        a = __fadd_rn(a, __fmul_rn(sm_acc[w][d], f));
      }
    }
    out[static_cast<size_t>(row) * Dh + d] =
        lsum > 0.0f ? __fdiv_rn(a, lsum) : 0.0f;
  }
}

template <int EPL>
void launch(const void* q, const void* kc, const void* ks, const void* vc,
            const void* vs, const void* pos, void* out, int rows, int G,
            int T, int Dh, int window, float scale, cudaStream_t stream) {
  int8_cache_attention_kernel<EPL><<<rows, THREADS, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const int8_t*>(kc),
      static_cast<const float*>(ks), static_cast<const int8_t*>(vc),
      static_cast<const float*>(vs), static_cast<const int*>(pos),
      static_cast<float*>(out), G, T, Dh, window, scale);
}

}  // namespace

// q (R*G, Dh) f32, codes (R, T, Dh) int8, scales (R, T) f32, pos (R,)
// int32, out (R*G, Dh) f32; window <= 0 means none.  Launches on `stream`
// and returns cudaGetLastError() (0 on success); Dh > 256 or an empty
// grid returns cudaErrorInvalidValue without launching.
extern "C" int repro_int8_cache_attention(const void* q, const void* kc,
                                          const void* ks, const void* vc,
                                          const void* vs, const void* pos,
                                          void* out, int R, int G, int T,
                                          int Dh, int window, float scale,
                                          void* stream) {
  const int rows = R * G;
  if (rows < 1 || T < 1 || Dh < 1 || Dh > MAX_DH)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Dh <= 32)
    launch<1>(q, kc, ks, vc, vs, pos, out, rows, G, T, Dh, window, scale, s);
  else if (Dh <= 64)
    launch<2>(q, kc, ks, vc, vs, pos, out, rows, G, T, Dh, window, scale, s);
  else if (Dh <= 128)
    launch<4>(q, kc, ks, vc, vs, pos, out, rows, G, T, Dh, window, scale, s);
  else
    launch<8>(q, kc, ks, vc, vs, pos, out, rows, G, T, Dh, window, scale, s);
  return static_cast<int>(cudaGetLastError());
}
