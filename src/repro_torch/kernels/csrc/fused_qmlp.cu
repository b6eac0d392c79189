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
// Bound on the H100: at Policy II (9-256-256-256-25) the work is tiny
// (~0.2 MB, ~0.14 G int8 ops at M = 512), so launch latency dominates.  At
// Policy III (9-4096-512-1024-25, 2.7 MB of int8 weights) the int8 ops
// (~2.7 G at M = 512) bound it.  The TPU design kept every layer's weights
// resident in VMEM; a Hopper block has at most 227 KB of shared memory, so
// here the weights stream from global memory, where the 50 MB L2 holds
// them for every block after the first, and only the activations of the
// block's rows live in shared memory.
//
// Layout: one block of 256 threads owns ROWS = 16 whole rows and walks
// every layer, with __syncthreads() between layers.  The int8 activations
// of its rows sit in two ping-pong shared buffers of ROWS x stride bytes,
// stride >= the widest layer rounded up to 16.  Each thread owns output
// columns n = tid, tid + 256, ...; it reads four K-consecutive codes of
// column n at a time, packs them into one int and feeds __dp4a against four
// activation codes of each row, so acc[ROWS] and the column sum of w are
// taken in the same loop.  Row sums of the layer input are one warp
// reduction per row.  The K tail is masked with zero codes (w loads past K
// read 0, and each activation row is zero-padded to a multiple of 4).
// Width 4096 needs 128 KB of activations: above 48 KB the launcher raises
// the block's dynamic shared-memory limit first.
//
// Bitwise agreement with the plain version (kernels/ref.py): the epilogue
// rounds each op on its own, in the reference's order --
// (x_delta * col_scale) * f32(corr), then + bias -- with __fmul_rn /
// __fadd_rn (the library is also built with -fmad=false); the requant
// divide is correctly rounded (__fdiv_rn) and rounds half to even (rintf).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_LAYERS = 8;
constexpr int ROWS = 16;
constexpr int THREADS = 256;

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
  int n_layers;
  int stride;
};

__device__ __forceinline__ int lo_nibble(int8_t b) {
  return static_cast<int>(static_cast<int8_t>(static_cast<uint8_t>(b) << 4)) >> 4;
}

__device__ __forceinline__ int hi_nibble(int8_t b) {
  return static_cast<int>(b) >> 4;
}

__device__ __forceinline__ int pack4(int c0, int c1, int c2, int c3) {
  return static_cast<int>((static_cast<uint32_t>(c0) & 0xFFu) |
                          ((static_cast<uint32_t>(c1) & 0xFFu) << 8) |
                          ((static_cast<uint32_t>(c2) & 0xFFu) << 16) |
                          ((static_cast<uint32_t>(c3) & 0xFFu) << 24));
}

// Codes w[k .. k+3, n] packed little-endian into one int (k % 4 == 0, k < K).
__device__ __forceinline__ int load_w4(const int8_t* __restrict__ w, int k,
                                       int n, int K, int N, int bits) {
  if (bits <= 4) {
    const int8_t b0 = w[static_cast<size_t>(k >> 1) * N + n];
    const int c0 = lo_nibble(b0);
    const int c1 = (k + 1 < K) ? hi_nibble(b0) : 0;
    int c2 = 0, c3 = 0;
    if (k + 2 < K) {
      const int8_t b1 = w[static_cast<size_t>((k >> 1) + 1) * N + n];
      c2 = lo_nibble(b1);
      c3 = (k + 3 < K) ? hi_nibble(b1) : 0;
    }
    return pack4(c0, c1, c2, c3);
  }
  const int8_t* col = w + static_cast<size_t>(k) * N + n;
  return pack4(col[0], (k + 1 < K) ? col[N] : 0,
               (k + 2 < K) ? col[2 * static_cast<size_t>(N)] : 0,
               (k + 3 < K) ? col[3 * static_cast<size_t>(N)] : 0);
}

__global__ void __launch_bounds__(THREADS)
fused_qmlp_kernel(const int8_t* __restrict__ x, int M, int K0, QMLPArgs a,
                  float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* buf[2] = {reinterpret_cast<int8_t*>(smem),
                    reinterpret_cast<int8_t*>(smem) + ROWS * a.stride};
  int* sum_h = reinterpret_cast<int*>(smem + 2 * ROWS * a.stride);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int row0 = blockIdx.x * ROWS;

  // input codes of this block's rows; rows past M and the K tail are zero
  const int k0_4 = (K0 + 3) & ~3;
  for (int i = tid; i < ROWS * k0_4; i += THREADS) {
    const int r = i / k0_4, c = i % k0_4;
    const int m = row0 + r;
    buf[0][r * a.stride + c] =
        (m < M && c < K0) ? x[static_cast<size_t>(m) * K0 + c] : 0;
  }
  __syncthreads();

  int cur = 0;
  for (int l = 0; l < a.n_layers; ++l) {
    const int K = a.k[l], N = a.n[l], bits = a.bits[l];
    const int K4 = (K + 3) & ~3;
    const int8_t* h = buf[cur];
    int8_t* h_next = buf[cur ^ 1];
    const bool last = (l + 1 == a.n_layers);

    for (int r = warp; r < ROWS; r += THREADS / 32) {
      int s = 0;
      for (int k = lane * 4; k < K4; k += 32 * 4)
        s = __dp4a(*reinterpret_cast<const int*>(h + r * a.stride + k),
                   0x01010101, s);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_down_sync(0xffffffffu, s, off);
      if (lane == 0) sum_h[r] = s;
    }
    __syncthreads();

    const float xd = *a.x_delta[l];
    const int xz = static_cast<int>(*a.x_zero[l]);
    const float nxd = last ? 1.0f : *a.x_delta[l + 1];
    const float nxz = last ? 0.0f : *a.x_zero[l + 1];
    const int8_t* w = a.codes[l];

    for (int n = tid; n < N; n += THREADS) {
      int acc[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] = 0;
      int sw = 0;
      for (int k = 0; k < K4; k += 4) {
        const int w4 = load_w4(w, k, n, K, N, bits);
        sw = __dp4a(w4, 0x01010101, sw);
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
          acc[r] = __dp4a(*reinterpret_cast<const int*>(h + r * a.stride + k),
                          w4, acc[r]);
      }
      const float scale = __fmul_rn(xd, a.col_scale[l][n]);
      const int wz = static_cast<int>(a.col_zero[l][n]);
      const float b = a.bias[l][n];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int corr = acc[r] - xz * sw - wz * sum_h[r] + K * xz * wz;
        const float y = __fadd_rn(__fmul_rn(scale, __int2float_rn(corr)), b);
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
    if (!last) {
      const int pad = ((N + 3) & ~3) - N;
      for (int i = tid; i < ROWS * pad; i += THREADS)
        h_next[(i / pad) * a.stride + N + i % pad] = 0;
    }
    __syncthreads();
    cur ^= 1;
  }
}

}  // namespace

// Launches on `stream`; returns a cudaError_t value (0 on success).  The
// per-layer arrays are host arrays of n_layers entries; `stride` is the
// shared-memory row stride in bytes (a multiple of 16, >= every width).
extern "C" int repro_fused_qmlp(const void* x, int M, int K0, int n_layers,
                                const void* const* codes,
                                const void* const* col_scale,
                                const void* const* col_zero,
                                const void* const* bias,
                                const void* const* x_delta,
                                const void* const* x_zero, const int* ks,
                                const int* ns, const int* bits, int stride,
                                void* out, void* stream) {
  if (n_layers < 1 || n_layers > MAX_LAYERS || stride % 16 != 0)
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
  }
  a.n_layers = n_layers;
  a.stride = stride;
  const size_t smem = 2 * static_cast<size_t>(ROWS) * stride + ROWS * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_qmlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  fused_qmlp_kernel<<<(M + ROWS - 1) / ROWS, THREADS, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), M, K0, a, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
