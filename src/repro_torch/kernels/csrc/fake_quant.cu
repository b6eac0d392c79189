// Kernel B5: fused affine quantize-dequantize (fake quantization) with a
// scalar (vmin, vmax) range, for sm_90a.
//
// Replaces repro/kernels/fake_quant.py: fake_quant_pallas (kernel
// _fake_quant_kernel).  With the range first extended to 0,
//   delta = (|vmin| + |vmax|) / 2**bits      (1 where that is 0)
//   zp    = round(-vmin / delta)
//   q     = clip(round(x / delta) + zp, 0, 2**bits - 1)
//   out   = delta * (q - zp)
// elementwise over a contiguous f32 tensor of any shape, flattened.  This
// is the inner loop of QAT (every weight and activation site of every
// forward) and of PTQ evaluation.
//
// Bound on the H100: bytes.  Each element is read once and written once
// (8 bytes) against about 8 flops, far below the ridge point.  The TPU
// kernel tiled a 2-D view into (256, 512) blocks in VMEM; here the tensor
// is flat, each thread walks a grid-stride loop over float4s (16-byte
// loads and stores, neighbouring threads on neighbouring addresses) when
// both pointers are 16-byte aligned, and single floats after the last
// whole float4 or when they are not.  The range is read through device
// pointers, so a QAT forward never waits on the host; each thread derives
// delta and zp itself from the two cached scalars (a few flops).  At the
// QAT sites of the CartPole net (at most 64 x 64 elements) launch latency
// sets the time, not the bytes.
//
// Numerics, bitwise equal to the plain version and the reference:
// correctly rounded divisions (__fdiv_rn) for x / delta and -vmin / delta,
// round half to even (rintf), each add, subtract and multiply rounded on
// its own (__fadd_rn, __fsub_rn, __fmul_rn; the library is also built
// with -fmad=false), and NaN kept by the range extension and the clip as
// torch.clamp keeps it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 16;  // 16 blocks per SM cover the card

struct Quantizer {
  float delta;
  float zp;
  float top;  // 2**bits - 1
};

__device__ __forceinline__ Quantizer from_range(const float* vmin_p,
                                                const float* vmax_p,
                                                int bits) {
  float lo = *vmin_p;
  float hi = *vmax_p;
  lo = lo > 0.0f ? 0.0f : lo;  // min(vmin, 0)
  hi = hi < 0.0f ? 0.0f : hi;  // max(vmax, 0)
  const float levels = static_cast<float>(1 << bits);
  float delta = __fdiv_rn(__fadd_rn(fabsf(lo), fabsf(hi)), levels);
  delta = delta == 0.0f ? 1.0f : delta;
  Quantizer p;
  p.delta = delta;
  p.zp = rintf(__fdiv_rn(-lo, delta));
  p.top = __fsub_rn(levels, 1.0f);
  return p;
}

__device__ __forceinline__ float fake_quant(float x, const Quantizer& p) {
  float q = __fadd_rn(rintf(__fdiv_rn(x, p.delta)), p.zp);
  q = q < 0.0f ? 0.0f : q;
  q = q > p.top ? p.top : q;
  return __fmul_rn(p.delta, __fsub_rn(q, p.zp));
}

__global__ void __launch_bounds__(THREADS)
fake_quant_kernel(const float* __restrict__ x,
                  const float* __restrict__ vmin,
                  const float* __restrict__ vmax, float* __restrict__ out,
                  long long n, int bits, int vec) {
  const Quantizer p = from_range(vmin, vmax, bits);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long tail = 0;
  if (vec) {
    const long long n4 = n >> 2;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (long long i = tid; i < n4; i += stride) {
      float4 v = x4[i];
      v.x = fake_quant(v.x, p);
      v.y = fake_quant(v.y, p);
      v.z = fake_quant(v.z, p);
      v.w = fake_quant(v.w, p);
      o4[i] = v;
    }
    tail = n4 << 2;
  }
  for (long long i = tail + tid; i < n; i += stride)
    out[i] = fake_quant(x[i], p);
}

}  // namespace

// x, out: n contiguous f32; vmin, vmax: one f32 each, on the card.  vec
// != 0 takes the float4 loop (both x and out 16-byte aligned).  Launches
// on `stream` and returns cudaGetLastError() (0 on success); n < 1 or bits
// outside [1, 16] returns cudaErrorInvalidValue without launching.
extern "C" int repro_fake_quant(const void* x, const void* vmin,
                                const void* vmax, void* out, long long n,
                                int bits, int vec, void* stream) {
  if (n < 1 || bits < 1 || bits > 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long units = vec ? (n + 3) / 4 : n;
  long long blocks = (units + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  fake_quant_kernel<<<static_cast<int>(blocks), THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(vmin),
      static_cast<const float*>(vmax), static_cast<float*>(out), n, bits,
      vec);
  return static_cast<int>(cudaGetLastError());
}
