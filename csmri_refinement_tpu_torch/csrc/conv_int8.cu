// One quantized SAME stride-1 conv layer, and the per-image requant between
// layers, for Hopper (sm_90a).
//
// Replaces the int8 mode of the TPU kernel
// csmri_refinement_tpu/ops/conv_pallas.py::_chain_kernel (quant=True),
// reached through csmri_refinement_tpu/ops/quantize.py::chain_forward_int8
// from the U-Net's eval chains with quantize_inference set. Per layer:
//
//     acc = conv_same(x, w)                       s8 x s8 -> s32, exact
//     y   = fma(acc, w_scale[co] * act_scale[b], bias)    f32
//     y   = y >= 0 ? y : leak * y
//     not last: y is written in f32 with the image's max |y|, then the
//               requant kernel turns it into the next layer's int8 input
//     last:     y is cast to the output type (bf16 or f32)
//
// NHWC int8 x (B, H, W, Cin), weights (k, k, Cout, Cin) int8 (each output
// channel's Cin weights contiguous), k in {3, 4}, SAME pad (1, 1) for k3 and
// (1, 2) for k4 with reflect, replicate or zero padding (int8 zero is the
// value 0: the quantization is symmetric), per-Cout f32 weight scales and
// bias, per-image f32 activation scales.
//
// Rounding: the dequant and bias are one explicit __fmaf_rn, rounded once.
// That is what the JAX package's acc * scale + bias compiles to on XLA's CPU
// backend (it contracts the multiply and the add), and the plain version
// rounds the exact float64 value once to match: one rounding apart is
// enough to flip a requant tie. The scale product is __fmul_rn, so that it
// is never contracted into the FMA. The requant divides (IEEE) and rounds
// half to even (rintf), as jnp.round does; the next scale is amax times
// f32(1/127), which is what XLA makes of the JAX package's amax / 127.0.
//
// What bounds it on the H100: operations. The seven quantized layers of the
// flagship U-Net at 256^2, B = 32, do 412.3 G int8 operations, 0.208 ms at
// 1979 TOP/s; the bytes the work needs (each chain's int8 input, weights and
// bf16 output, 629.7 MB) take 0.188 ms at 3.35 TB/s. The f32 intermediates
// and the requant launches of this one-launch-per-layer design are extra
// cost on top of that bound.
//
// Design: K2's implicit GEMM (csrc/conv_chain.cu) with int8 operands. A
// block computes 16 x 16 output pixels by NT output channels of one image.
// Per chunk of 32 input channels it stages the input halo tile (pad mode in
// the index map) and the chunk's k*k*NT weight rows in shared memory with
// 16-byte loads, each pixel and weight row in a 48-byte slot: 32 bytes used,
// the rest spreads the fragment reads over all 32 banks. Each warp owns two
// output rows; per tap it reads the A fragments of
// mma.sync.m16n8k32.s8.s8.s32 (16 pixels x 32 channels) straight out of
// the halo at the tap's offset with 4-byte loads, which any pixel offset
// satisfies (WMMA's int8 loads would need 32-byte alignment, which odd taps
// miss), and accumulates in int32 registers. The epilogue runs from the
// registers. The requant is a second, elementwise kernel: the TPU kernel
// keeps a whole chain on chip, which is later work here, as are wgmma, TMA
// and a pipelined operand ring.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kTileH = 16;     // output rows per block: 2 per warp
constexpr int kTileW = 16;     // output columns per block: MMA M = 16
constexpr int kChunk = 32;     // input channels staged per step: MMA K = 32
constexpr int kSlot = 48;      // shared-memory bytes per pixel / weight row

enum PadMode { kZero = 0, kReflect = 1, kReplicate = 2 };

// Source index of padded position i along an axis of length n, or -1 for a
// zero. Positions more than one pad beyond the image feed only outputs
// outside it (tile overhang); the clamp keeps their reads in bounds.
__device__ __forceinline__ int pad_index(int i, int n, int mode) {
  if (i >= 0 && i < n) return i;
  if (mode == kZero) return -1;
  if (mode == kReflect) i = i < 0 ? -i : 2 * (n - 1) - i;
  return min(max(i, 0), n - 1);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ unsigned ld32(const unsigned char* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// d = a (16x32 s8, row-major) * b (32x8 s8, column-major) + d, in s32.
__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int K, int NT>
struct Tile {
  static constexpr int kPad = (K - 1) / 2;  // top/left SAME pad
  static constexpr int kHaloH = kTileH + K - 1;
  static constexpr int kHaloW = kTileW + K - 1;
  static constexpr int kHaloBytes = (kHaloH * kHaloW * kSlot + 127) / 128 * 128;
  static constexpr int kSmem = kHaloBytes + K * K * NT * kSlot;
};

template <typename OutT, int K, int NT>
__global__ void __launch_bounds__(kThreads)
conv_int8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wt,
                 const float* __restrict__ w_scale,
                 const float* __restrict__ a_scale,
                 const float* __restrict__ bias, OutT* __restrict__ y,
                 unsigned* __restrict__ amax, int h, int w, int cin, int cout,
                 int pad_mode, int has_leak, float leak) {
  using TL = Tile<K, NT>;
  constexpr int NF = NT / 8;  // MMA N = 8
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* halo = smem;
  unsigned char* ws = smem + TL::kHaloBytes;

  const int tiles_w = (w + kTileW - 1) / kTileW;
  const int oy0 = (blockIdx.x / tiles_w) * kTileH;
  const int ox0 = (blockIdx.x % tiles_w) * kTileW;
  const int n0 = blockIdx.z * NT;
  const int img = blockIdx.y;
  const int8_t* xb = x + (size_t)img * h * w * cin;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);

  int acc[2][NF][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int f = 0; f < NF; ++f)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[r][f][i] = 0;

  for (int c0 = 0; c0 < cin; c0 += kChunk) {
    for (int i = tid; i < TL::kHaloH * TL::kHaloW * 2; i += kThreads) {
      const int v = i & 1;
      const int p = i >> 1;
      const int sy = pad_index(oy0 + p / TL::kHaloW - TL::kPad, h, pad_mode);
      const int sx = pad_index(ox0 + p % TL::kHaloW - TL::kPad, w, pad_mode);
      uint4 val = zero4;
      if (sy >= 0 && sx >= 0)
        val = *reinterpret_cast<const uint4*>(
            xb + ((size_t)sy * w + sx) * cin + c0 + v * 16);
      *reinterpret_cast<uint4*>(halo + p * kSlot + v * 16) = val;
    }
    for (int i = tid; i < K * K * NT * 2; i += kThreads) {
      const int v = i & 1;
      const int q = i >> 1;  // tap * NT + n
      const int n = q % NT;
      const int tap = q / NT;
      *reinterpret_cast<uint4*>(ws + q * kSlot + v * 16) =
          *reinterpret_cast<const uint4*>(
              wt + ((size_t)tap * cout + n0 + n) * cin + c0 + v * 16);
    }
    __syncthreads();

#pragma unroll 1
    for (int tap = 0; tap < K * K; ++tap) {
      const int dy = tap / K, dx = tap % K;
      unsigned a[2][4];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // A: rows = the 16 output pixels of row 2*warp + r, cols = channels
        const unsigned char* base =
            halo + ((2 * warp + r + dy) * TL::kHaloW + dx) * kSlot + t * 4;
        a[r][0] = ld32(base + g * kSlot);
        a[r][1] = ld32(base + (g + 8) * kSlot);
        a[r][2] = ld32(base + g * kSlot + 16);
        a[r][3] = ld32(base + (g + 8) * kSlot + 16);
      }
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        // B: cols = output channels f*8 + g, rows = channels
        const unsigned char* wb = ws + (tap * NT + f * 8 + g) * kSlot + t * 4;
        const unsigned b0 = ld32(wb), b1 = ld32(wb + 16);
        mma_s8(acc[0][f], a[0], b0, b1);
        mma_s8(acc[1][f], a[1], b0, b1);
      }
    }
    __syncthreads();
  }

  const float as = a_scale[img];
  float local_max = 0.f;
  OutT* yb = y + (size_t)img * h * w * cout;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int oy = oy0 + 2 * warp + r;
#pragma unroll
    for (int f = 0; f < NF; ++f) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // accumulator element i: pixel g (+8 for i >= 2), channel 2t + i%2
        const int ox = ox0 + g + (i >> 1) * 8;
        const int n = n0 + f * 8 + t * 2 + (i & 1);
        if (oy < h && ox < w) {
          float v = __fmaf_rn(__int2float_rn(acc[r][f][i]),
                              __fmul_rn(w_scale[n], as), bias[n]);
          if (has_leak && !(v >= 0.f)) v = __fmul_rn(leak, v);
          store(yb + ((size_t)oy * w + ox) * cout + n, v);
          local_max = fmaxf(local_max, fabsf(v));
        }
      }
    }
  }
  if (amax != nullptr) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      local_max =
          fmaxf(local_max, __shfl_xor_sync(0xffffffffu, local_max, off));
    if (lane == 0) atomicMax(amax + img, __float_as_uint(local_max));
  }
}

__device__ __forceinline__ signed char quant(float v, float s) {
  const float r = fminf(fmaxf(rintf(__fmul_rn(v, s)), -127.f), 127.f);
  return (signed char)r;
}

// x_next = clip(rint(y * 127 / max(amax, 1e-8)), +-127), four values a
// thread; scale_next = max(amax, 1e-8) * f32(1/127).
__global__ void requant_kernel(const float4* __restrict__ y,
                               const float* __restrict__ amax,
                               char4* __restrict__ xi,
                               float* __restrict__ scale, int batch,
                               long long per_image4) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < batch) scale[i] = __fmul_rn(fmaxf(amax[i], 1e-8f), 1.f / 127.f);
  const long long total = per_image4 * batch;
  for (; i < total; i += (long long)gridDim.x * blockDim.x) {
    const float s = __fdiv_rn(127.f, fmaxf(amax[i / per_image4], 1e-8f));
    const float4 v = y[i];
    xi[i] = make_char4(quant(v.x, s), quant(v.y, s), quant(v.z, s),
                       quant(v.w, s));
  }
}

template <typename OutT, int K, int NT>
int launch(const void* x, const void* wt, const void* w_scale,
           const void* a_scale, const void* bias, void* y, void* amax,
           int batch, int h, int w, int cin, int cout, int pad_mode,
           int has_leak, float leak, cudaStream_t st) {
  auto kern = conv_int8_kernel<OutT, K, NT>;
  const int smem = Tile<K, NT>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned tiles =
      (unsigned)((h + kTileH - 1) / kTileH) * ((w + kTileW - 1) / kTileW);
  dim3 grid(tiles, batch, cout / NT);
  kern<<<grid, kThreads, smem, st>>>(
      (const int8_t*)x, (const int8_t*)wt, (const float*)w_scale,
      (const float*)a_scale, (const float*)bias, (OutT*)y, (unsigned*)amax, h,
      w, cin, cout, pad_mode, has_leak, leak);
  return (int)cudaGetLastError();
}

template <typename OutT, int K>
int launch_nt(const void* x, const void* wt, const void* w_scale,
              const void* a_scale, const void* bias, void* y, void* amax,
              int batch, int h, int w, int cin, int cout, int pad_mode,
              int has_leak, float leak, cudaStream_t st) {
  if (cout % 64 == 0)
    return launch<OutT, K, 64>(x, wt, w_scale, a_scale, bias, y, amax, batch,
                               h, w, cin, cout, pad_mode, has_leak, leak, st);
  if (cout % 32 == 0)
    return launch<OutT, K, 32>(x, wt, w_scale, a_scale, bias, y, amax, batch,
                               h, w, cin, cout, pad_mode, has_leak, leak, st);
  return launch<OutT, K, 16>(x, wt, w_scale, a_scale, bias, y, amax, batch, h,
                             w, cin, cout, pad_mode, has_leak, leak, st);
}

template <typename OutT>
int launch_k(const void* x, const void* wt, const void* w_scale,
             const void* a_scale, const void* bias, void* y, void* amax,
             int batch, int h, int w, int cin, int cout, int k, int pad_mode,
             int has_leak, float leak, cudaStream_t st) {
  if (k == 3)
    return launch_nt<OutT, 3>(x, wt, w_scale, a_scale, bias, y, amax, batch,
                              h, w, cin, cout, pad_mode, has_leak, leak, st);
  return launch_nt<OutT, 4>(x, wt, w_scale, a_scale, bias, y, amax, batch, h,
                            w, cin, cout, pad_mode, has_leak, leak, st);
}

}  // namespace

// x: (batch, h, w, cin) int8, wt: (k, k, cout, cin) int8, both contiguous
// and 16-byte aligned; w_scale, bias: (cout,) f32; a_scale: (batch,) f32;
// y: (batch, h, w, cout) in bf16 if out_bf16 else f32; amax: (batch,)
// uint32 zeroed by the caller (max |y| per image is atomicMax-ed into it as
// float bits), or null to skip it. pad_mode: 0 zero, 1 reflect, 2
// replicate. Launches on `stream`; returns cudaGetLastError() after it.
extern "C" int conv_layer_int8(const void* x, const void* wt,
                               const void* w_scale, const void* a_scale,
                               const void* bias, void* y, void* amax,
                               int batch, int h, int w, int cin, int cout,
                               int k, int pad_mode, int out_bf16,
                               int has_leak, float leak, void* stream) {
  if (batch < 1 || batch > 65535 || h < 1 || w < 1 || cin < kChunk ||
      cin % kChunk || cout < 16 || cout % 16 || cout / 16 > 65535 ||
      pad_mode < 0 || pad_mode > 2 || (k != 3 && k != 4) ||
      (uintptr_t)x % 16 || (uintptr_t)wt % 16 ||
      (pad_mode == kReflect && (h < 2 || w < 2))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  if (out_bf16)
    return launch_k<__nv_bfloat16>(x, wt, w_scale, a_scale, bias, y, amax,
                                   batch, h, w, cin, cout, k, pad_mode,
                                   has_leak, leak, st);
  return launch_k<float>(x, wt, w_scale, a_scale, bias, y, amax, batch, h, w,
                         cin, cout, k, pad_mode, has_leak, leak, st);
}

// y: (batch, per_image) f32, amax: (batch,) f32, xi: (batch, per_image)
// int8, scale: (batch,) f32; per_image a multiple of 4, y 16-byte aligned.
extern "C" int requant_int8(const void* y, const void* amax, void* xi,
                            void* scale, int batch, int per_image,
                            void* stream) {
  if (batch < 1 || per_image < 4 || per_image % 4 || (uintptr_t)y % 16 ||
      (uintptr_t)xi % 4) {
    return (int)cudaErrorInvalidValue;
  }
  const long long per_image4 = per_image / 4;
  const long long total = per_image4 * batch;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;
  if (blocks * threads < batch) blocks = (batch + threads - 1) / threads;
  requant_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float4*)y, (const float*)amax, (char4*)xi, (float*)scale, batch,
      per_image4);
  return (int)cudaGetLastError();
}
