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
// The QAT site kernel (repro_fake_quant_site) does in one launch what one
// quantization-aware-training site of repro/core/fake_quant.py does:
//  * activation site (QATContext.activation): the batch min and max of x
//    (NaN propagated as torch.aminmax does), extended to 0; the observer
//    update from the old state read through device pointers -- the EMA
//    d * v + (1 - d) * b (each product and the sum rounded on its own, d
//    and 1 - d rounded to float32 on the host as torch rounds a Python
//    scalar), where(initialized, ema, batch), where(monitoring, new, old),
//    initialized | monitoring -- written to three fresh 0-d tensors (the
//    contexts are functional), then where(enabled & initialized, fq(x), x)
//    over the new range;
//  * weight site (QATContext.weight): the range is the tensor's own min and
//    max; where(enabled, fq(w), w).
// monitoring = step < quant_delay and enabled = step >= quant_delay are
// taken in the kernel from the device step (int32 or int64), so the
// context launches no compare and nothing waits on the host.  Every site
// of the ported paths (the CartPole MLP at batch <= 64: at most 4,096
// elements) runs as one block of 512 threads that holds x in registers
// between the reduction and the quantize pass: one launch, x read once.
// A larger tensor takes a partial-range pass (one min / max pair per
// block) and then a quantize pass whose every block reduces those pairs
// itself: two launches, and the wrapper counts both.  The site's bound
// is bytes (x read once, out written once) and, at these sizes, launch
// latency: what the kernel saves is the ~16 other launches of the
// composition.
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

__device__ __forceinline__ Quantizer from_range(float lo, float hi, int bits) {
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
  const Quantizer p = from_range(*vmin, *vmax, bits);
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


// ---- the QAT site kernel ------------------------------------------------

constexpr int SITE_THREADS = 512;
constexpr int SITE_PER_THREAD = 8;
constexpr long long SITE_ONE_BLOCK = SITE_THREADS * SITE_PER_THREAD;  // 4096
constexpr int RANGE_BLOCKS = 264;  // partial ranges of a large site

enum SiteKind { WEIGHT_SITE = 0, ACTIVATION_SITE = 1 };

struct SiteArgs {
  const float* x;
  float* out;
  long long n;
  int bits;
  int kind;
  const float* vmin;             // activation: the old state
  const float* vmax;
  const unsigned char* init;     // torch.bool, one byte
  float* new_vmin;               // activation: the new state
  float* new_vmax;
  unsigned char* new_init;
  const void* step;              // 0-d int32 or int64
  int step_is64;
  long long quant_delay;
  float decay;                   // float32(d), float32(1 - d)
  float one_minus_decay;
};

// min / max that return NaN when either side is NaN, as torch.aminmax does
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// The block's min and max of every thread's (lo, hi); every thread gets
// them.  Called once per kernel.
__device__ __forceinline__ void block_range(float& lo, float& hi) {
  __shared__ float s_lo[32], s_hi[32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = nan_min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = nan_max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    s_lo[warp] = lo;
    s_hi[warp] = hi;
  }
  __syncthreads();
  lo = s_lo[0];
  hi = s_hi[0];
  for (int w = 1; w < static_cast<int>(blockDim.x >> 5); ++w) {
    lo = nan_min(lo, s_lo[w]);
    hi = nan_max(hi, s_hi[w]);
  }
}

struct SitePlan {
  Quantizer q;
  bool apply;                    // fq(x) where true, x where false
};

// The step and the old observer state, read at the kernel's start so
// that their loads overlap those of x.
struct SiteState {
  long long step;
  float vmin, vmax;
  bool init;
};

__device__ __forceinline__ SiteState load_state(const SiteArgs& a) {
  SiteState s;
  s.step = a.step_is64
               ? *static_cast<const long long*>(a.step)
               : static_cast<long long>(*static_cast<const int*>(a.step));
  s.vmin = s.vmax = 0.0f;
  s.init = false;
  if (a.kind == ACTIVATION_SITE) {
    s.vmin = *a.vmin;
    s.vmax = *a.vmax;
    s.init = *a.init != 0;
  }
  return s;
}

// The site's flags, observer update and quantizer from the batch range;
// `write` stores the new observer state.
__device__ __forceinline__ SitePlan site_plan(const SiteArgs& a,
                                              const SiteState& s, float lo,
                                              float hi, bool write) {
  const float bmin = lo > 0.0f ? 0.0f : lo;   // torch.clamp keeps NaN
  const float bmax = hi < 0.0f ? 0.0f : hi;
  const bool monitoring = s.step < a.quant_delay;
  const bool enabled = s.step >= a.quant_delay;
  SitePlan p;
  if (a.kind == WEIGHT_SITE) {
    p.q = from_range(bmin, bmax, a.bits);
    p.apply = enabled;
    return p;
  }
  const float old_min = s.vmin, old_max = s.vmax;
  const bool old_init = s.init;
  const float ema_min = __fadd_rn(__fmul_rn(old_min, a.decay),
                                  __fmul_rn(bmin, a.one_minus_decay));
  const float ema_max = __fadd_rn(__fmul_rn(old_max, a.decay),
                                  __fmul_rn(bmax, a.one_minus_decay));
  const float new_min = monitoring ? (old_init ? ema_min : bmin) : old_min;
  const float new_max = monitoring ? (old_init ? ema_max : bmax) : old_max;
  const bool new_init = old_init || monitoring;
  if (write) {
    *a.new_vmin = new_min;
    *a.new_vmax = new_max;
    *a.new_init = new_init ? 1 : 0;
  }
  p.q = from_range(new_min, new_max, a.bits);
  p.apply = enabled && new_init;
  return p;
}

// A site of at most SITE_ONE_BLOCK elements: one block, x in registers.
__global__ void __launch_bounds__(SITE_THREADS)
site_block_kernel(SiteArgs a) {
  const SiteState s = load_state(a);
  float v[SITE_PER_THREAD];
  float lo = INFINITY, hi = -INFINITY;
#pragma unroll
  for (int j = 0; j < SITE_PER_THREAD; ++j) {
    const long long i = threadIdx.x + static_cast<long long>(j) * SITE_THREADS;
    v[j] = 0.0f;
    if (i < a.n) {
      v[j] = a.x[i];
      lo = nan_min(lo, v[j]);
      hi = nan_max(hi, v[j]);
    }
  }
  block_range(lo, hi);
  const SitePlan p = site_plan(a, s, lo, hi, threadIdx.x == 0);
#pragma unroll
  for (int j = 0; j < SITE_PER_THREAD; ++j) {
    const long long i = threadIdx.x + static_cast<long long>(j) * SITE_THREADS;
    if (i < a.n) a.out[i] = p.apply ? fake_quant(v[j], p.q) : v[j];
  }
}

// A larger site, pass 1: each block's min / max into partials[2b, 2b + 1].
__global__ void __launch_bounds__(THREADS)
site_range_kernel(const float* __restrict__ x, long long n,
                  float* __restrict__ partials) {
  float lo = INFINITY, hi = -INFINITY;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const float v = x[i];
    lo = nan_min(lo, v);
    hi = nan_max(hi, v);
  }
  block_range(lo, hi);
  if (threadIdx.x == 0) {
    partials[2 * blockIdx.x] = lo;
    partials[2 * blockIdx.x + 1] = hi;
  }
}

// Pass 2: every block reduces the partial ranges itself, block 0 writes
// the new state, and all quantize their share of x.
__global__ void __launch_bounds__(THREADS)
site_apply_kernel(SiteArgs a, const float* __restrict__ partials,
                  int n_parts, int vec) {
  const SiteState s = load_state(a);
  float lo = INFINITY, hi = -INFINITY;
  for (int b = threadIdx.x; b < n_parts; b += blockDim.x) {
    lo = nan_min(lo, partials[2 * b]);
    hi = nan_max(hi, partials[2 * b + 1]);
  }
  block_range(lo, hi);
  const SitePlan p =
      site_plan(a, s, lo, hi, blockIdx.x == 0 && threadIdx.x == 0);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long tail = 0;
  if (vec) {
    const long long n4 = a.n >> 2;
    const float4* x4 = reinterpret_cast<const float4*>(a.x);
    float4* o4 = reinterpret_cast<float4*>(a.out);
    for (long long i = tid; i < n4; i += stride) {
      float4 v = x4[i];
      if (p.apply) {
        v.x = fake_quant(v.x, p.q);
        v.y = fake_quant(v.y, p.q);
        v.z = fake_quant(v.z, p.q);
        v.w = fake_quant(v.w, p.q);
      }
      o4[i] = v;
    }
    tail = n4 << 2;
  }
  for (long long i = tail + tid; i < a.n; i += stride)
    a.out[i] = p.apply ? fake_quant(a.x[i], p.q) : a.x[i];
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

// f32 scratch a site of n elements needs (its partial ranges): 0 where it
// runs as one block.
extern "C" long long repro_fake_quant_site_scratch(long long n) {
  return n <= SITE_ONE_BLOCK ? 0 : 2LL * RANGE_BLOCKS;
}

// One QAT site (see the note at the top).  x, out: n contiguous f32 on
// the card; kind 0 = weight (the state pointers unused, may be null), 1 =
// activation (vmin, vmax f32 and init bool: the old state; new_*: three
// fresh 0-d tensors for the new one); step: a 0-d int32 (step_is64 = 0)
// or int64 tensor; scratch: repro_fake_quant_site_scratch(n) floats; vec
// != 0: x and out 16-byte aligned.  Returns cudaGetLastError() (0 on
// success); bad arguments return cudaErrorInvalidValue without launching.
extern "C" int repro_fake_quant_site(
    const void* x, void* out, long long n, int bits, int kind,
    const void* vmin, const void* vmax, const void* init, void* new_vmin,
    void* new_vmax, void* new_init, const void* step, int step_is64,
    long long quant_delay, float decay, float one_minus_decay,
    void* scratch, int vec, void* stream) {
  if (n < 1 || bits < 1 || bits > 16 ||
      (kind != WEIGHT_SITE && kind != ACTIVATION_SITE))
    return static_cast<int>(cudaErrorInvalidValue);
  SiteArgs a;
  a.x = static_cast<const float*>(x);
  a.out = static_cast<float*>(out);
  a.n = n;
  a.bits = bits;
  a.kind = kind;
  a.vmin = static_cast<const float*>(vmin);
  a.vmax = static_cast<const float*>(vmax);
  a.init = static_cast<const unsigned char*>(init);
  a.new_vmin = static_cast<float*>(new_vmin);
  a.new_vmax = static_cast<float*>(new_vmax);
  a.new_init = static_cast<unsigned char*>(new_init);
  a.step = step;
  a.step_is64 = step_is64;
  a.quant_delay = quant_delay;
  a.decay = decay;
  a.one_minus_decay = one_minus_decay;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= SITE_ONE_BLOCK) {
    site_block_kernel<<<1, SITE_THREADS, 0, st>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  long long parts = (n + 4LL * THREADS - 1) / (4LL * THREADS);
  if (parts > RANGE_BLOCKS) parts = RANGE_BLOCKS;
  float* partials = static_cast<float*>(scratch);
  site_range_kernel<<<static_cast<int>(parts), THREADS, 0, st>>>(a.x, n,
                                                                 partials);
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const long long units = vec ? (n + 3) / 4 : n;
  long long blocks = (units + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  site_apply_kernel<<<static_cast<int>(blocks), THREADS, 0, st>>>(
      a, partials, static_cast<int>(parts), vec);
  return static_cast<int>(cudaGetLastError());
}
