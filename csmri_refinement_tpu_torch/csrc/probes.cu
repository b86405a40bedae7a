// Primitive probes for Hopper (sm_90a): tiny kernels that check, each
// against a plain PyTorch version, the primitives the port's conv kernels
// are built from.
//
// Replace the TPU probes csmri_refinement_tpu/scripts/probe_mosaic_prims.py
// (K4: which Mosaic layout primitives a bf16 Pallas kernel may use) and
// scripts/probe_int8_prims.py (K5: the int8 primitives of the quantized
// chain kernel). The TPU asked whether its compiler accepts a lane roll, an
// unaligned slice or an s8 dot; here the same questions are asked of what
// csrc/conv_chain.cu (K2) and csrc/conv_int8.cu (K3) do: bf16 tiles staged
// in shared memory and moved as single values or 32-bit pairs, rows read
// and written at unaligned offsets, a WMMA bf16 A fragment loaded at an
// odd-pixel offset (K2's halo reads), s8 x s8 -> s32 mma.sync (K3's MMA),
// and the f32 dequant and block-wide requant (K3's epilogue).
//
// What bounds them: bytes, a 256 x 128 tile in and out (the s8 product's
// 8.4 M operations take 4 ns at 1979 TOP/s). They run as one block and are
// checks, not measurements of speed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int L = 128;  // lanes (columns) of every probe tile
constexpr int kThreads = 256;

enum Bf16Op {
  kLaneRoll = 0,      // y = roll(x, 32, axis=1), value by value
  kLaneRollPair = 1,  // the same, moved as 32-bit bf16 pairs
  kRowRoll = 2,       // y = roll(x, 1, axis=0)
  kRowRead = 3,       // y = x[1:rows-15]
  kRowWrite = 4,      // y = 0; y[1:rows-15] = x[0:rows-16]
  kIotaSelect = 5,    // y = where(col < 32, 2x, x)
  kMidDim = 6,        // x (rows/8, 8, L): y = x[:, 3, :]
  kScratch = 7,       // s[8:8+rows] = x; s[0:8] = s[8:16]; y = 2 s[1:1+rows]
  kPairRoll64 = 8,    // y = roll(x, 64, axis=1) as 32-bit pairs
  kWmmaOddPixel = 9,  // x as (rows*L/16) pixels x 16: y (f32) = pixels
                      // [1 : rows*L/16 - 15] through WMMA A-fragment loads
                      // at odd pixel offsets times the identity
};

__device__ __forceinline__ __nv_bfloat16 twice(__nv_bfloat16 v) {
  return __float2bfloat16(2.f * __bfloat162float(v));
}

__global__ void __launch_bounds__(kThreads)
bf16_probe(int op, const __nv_bfloat16* __restrict__ x, void* __restrict__ out,
           int rows) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* s = reinterpret_cast<__nv_bfloat16*>(smem);
  const int tid = threadIdx.x;
  const int n = rows * L;
  const int off = op == kScratch ? 8 * L : 0;
  for (int i = tid; i < n; i += kThreads) s[off + i] = x[i];
  __syncthreads();

  __nv_bfloat16* y = reinterpret_cast<__nv_bfloat16*>(out);
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  switch (op) {
    case kLaneRoll:
      for (int i = tid; i < n; i += kThreads)
        y[i] = s[i / L * L + (i % L + L - 32) % L];
      break;
    case kLaneRollPair:
    case kPairRoll64: {
      constexpr int W = L / 2;  // 32-bit words per row
      const int shift = op == kLaneRollPair ? 16 : 32;
      const uint32_t* sw = reinterpret_cast<const uint32_t*>(s);
      uint32_t* yw = reinterpret_cast<uint32_t*>(out);
      for (int i = tid; i < rows * W; i += kThreads)
        yw[i] = sw[i / W * W + (i % W + W - shift) % W];
      break;
    }
    case kRowRoll:
      for (int i = tid; i < n; i += kThreads)
        y[i] = s[((i / L + rows - 1) % rows) * L + i % L];
      break;
    case kRowRead:
      for (int i = tid; i < (rows - 16) * L; i += kThreads) y[i] = s[L + i];
      break;
    case kRowWrite:
      for (int i = tid; i < n; i += kThreads) {
        const int r = i / L;
        y[i] = r >= 1 && r < rows - 15 ? s[i - L] : zero;
      }
      break;
    case kIotaSelect:
      for (int i = tid; i < n; i += kThreads)
        y[i] = i % L < 32 ? twice(s[i]) : s[i];
      break;
    case kMidDim:
      for (int i = tid; i < n / 8; i += kThreads)
        y[i] = s[(i / L * 8 + 3) * L + i % L];
      break;
    case kScratch:
      for (int i = tid; i < 8 * L; i += kThreads) s[i] = s[8 * L + i];
      __syncthreads();
      for (int i = tid; i < n; i += kThreads) y[i] = twice(s[L + i]);
      break;
    case kWmmaOddPixel: {
      __nv_bfloat16* eye = s + n;  // 16 x 16 identity, after the tile
      for (int i = tid; i < 256; i += kThreads)
        eye[i] = __float2bfloat16(i / 16 == i % 16 ? 1.f : 0.f);
      __syncthreads();
      float* yf = reinterpret_cast<float*>(out);
      const int tiles = (n / 16 - 16) / 16;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> b;
      wmma::load_matrix_sync(b, eye, 16);
      for (int tile = tid / 32; tile < tiles; tile += kThreads / 32) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a;
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
        wmma::fill_fragment(c, 0.f);
        wmma::load_matrix_sync(a, s + (16 * tile + 1) * 16, 16);
        wmma::mma_sync(c, a, b, c);
        wmma::store_matrix_sync(yf + tile * 256, c, 16, wmma::mem_row_major);
      }
      break;
    }
  }
}

enum Int8Op {
  kMma = 0,         // y (s32) = a (R x 128 s8) . b (128 x 128 s8)
  kWordRoll = 1,    // y = roll(a, 32, axis=1), moved as 32-bit words
  kSelect = 2,      // y = where(col < 32, a, 0)
  kRequant = 3,     // y = clip(rint(f * 127 / max(max|f|, 1e-8)), +-127)
  kMmaDequant = 4,  // y (f32) = (a . b) * 0.01
};

__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four int8 of column n, rows k..k+3 of a row-major (., L) matrix, packed
// lowest row in the lowest byte: a column-major B fragment register.
__device__ __forceinline__ unsigned column4(const int8_t* b, int k, int n) {
  return (unsigned)(uint8_t)b[k * L + n] |
         (unsigned)(uint8_t)b[(k + 1) * L + n] << 8 |
         (unsigned)(uint8_t)b[(k + 2) * L + n] << 16 |
         (unsigned)(uint8_t)b[(k + 3) * L + n] << 24;
}

__global__ void __launch_bounds__(kThreads)
int8_probe(int op, const void* __restrict__ a_ptr,
           const int8_t* __restrict__ b, void* __restrict__ out, int rows) {
  __shared__ float warp_max[kThreads / 32];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int n = rows * L;
  const int8_t* a = reinterpret_cast<const int8_t*>(a_ptr);
  switch (op) {
    case kMma:
    case kMmaDequant: {
      const int g = lane >> 2, t = lane & 3;
      const int tiles = (rows / 16) * (L / 8);
      for (int tile = warp; tile < tiles; tile += kThreads / 32) {
        const int m0 = tile / (L / 8) * 16, n0 = tile % (L / 8) * 8;
        int d[4] = {0, 0, 0, 0};
        for (int k0 = 0; k0 < L; k0 += 32) {
          const int8_t* ar = a + (m0 + g) * L + k0 + t * 4;
          const unsigned af[4] = {
              *reinterpret_cast<const unsigned*>(ar),
              *reinterpret_cast<const unsigned*>(ar + 8 * L),
              *reinterpret_cast<const unsigned*>(ar + 16),
              *reinterpret_cast<const unsigned*>(ar + 8 * L + 16)};
          mma_s8(d, af, column4(b, k0 + t * 4, n0 + g),
                 column4(b, k0 + 16 + t * 4, n0 + g));
        }
        for (int i = 0; i < 4; ++i) {
          const int idx = (m0 + g + (i >> 1) * 8) * L + n0 + t * 2 + (i & 1);
          if (op == kMma)
            reinterpret_cast<int*>(out)[idx] = d[i];
          else
            reinterpret_cast<float*>(out)[idx] =
                __fmul_rn(__int2float_rn(d[i]), 0.01f);
        }
      }
      break;
    }
    case kWordRoll: {
      constexpr int W = L / 4;
      const uint32_t* aw = reinterpret_cast<const uint32_t*>(a);
      uint32_t* yw = reinterpret_cast<uint32_t*>(out);
      for (int i = tid; i < rows * W; i += kThreads)
        yw[i] = aw[i / W * W + (i % W + W - 8) % W];
      break;
    }
    case kSelect: {
      int8_t* y = reinterpret_cast<int8_t*>(out);
      for (int i = tid; i < n; i += kThreads) y[i] = i % L < 32 ? a[i] : 0;
      break;
    }
    case kRequant: {
      const float* f = reinterpret_cast<const float*>(a_ptr);
      float m = 0.f;
      for (int i = tid; i < n; i += kThreads) m = fmaxf(m, fabsf(f[i]));
      for (int o = 16; o > 0; o >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      if (lane == 0) warp_max[warp] = m;
      __syncthreads();
      m = 0.f;
      for (int w = 0; w < kThreads / 32; ++w) m = fmaxf(m, warp_max[w]);
      const float sc = __fdiv_rn(127.f, fmaxf(m, 1e-8f));
      int8_t* y = reinterpret_cast<int8_t*>(out);
      for (int i = tid; i < n; i += kThreads)
        y[i] = (int8_t)fminf(fmaxf(rintf(__fmul_rn(f[i], sc)), -127.f), 127.f);
      break;
    }
  }
}

}  // namespace

// One K4 probe on a contiguous bf16 (rows, 128) tile x (rows a multiple of
// 16, at most 256; the mid-dim probe reads it as (rows/8, 8, 128)); out is
// sized for the probe's result. Returns cudaGetLastError() after the launch.
extern "C" int probe_bf16(int op, const void* x, void* out, int rows,
                          void* stream) {
  if (op < kLaneRoll || op > kWmmaOddPixel || rows < 32 || rows > 512 ||
      (uintptr_t)x % 16 || (uintptr_t)out % 32) {
    return (int)cudaErrorInvalidValue;
  }
  const int smem = (rows + 16) * L * 2 + 512;
  cudaError_t err = cudaFuncSetAttribute(
      bf16_probe, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  bf16_probe<<<1, kThreads, smem, (cudaStream_t)stream>>>(
      op, (const __nv_bfloat16*)x, out, rows);
  return (int)cudaGetLastError();
}

// One K5 probe: a is int8 (rows, 128) (f32 for the requant probe), b int8
// (128, 128) for the MMA probes (else unused); rows a multiple of 16.
extern "C" int probe_int8(int op, const void* a, const void* b, void* out,
                          int rows, void* stream) {
  if (op < kMma || op > kMmaDequant || rows < 16 || rows % 16 ||
      (uintptr_t)a % 16 || (uintptr_t)out % 16 ||
      ((op == kMma || op == kMmaDequant) && b == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  int8_probe<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      op, a, (const int8_t*)b, out, rows);
  return (int)cudaGetLastError();
}
