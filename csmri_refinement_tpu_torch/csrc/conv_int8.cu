// One quantized SAME stride-1 conv layer, and the per-image requant
// between layers, for Hopper (sm_90a).
//
// Replaces the int8 mode of the TPU kernel
// csmri_refinement_tpu/ops/conv_pallas.py::_chain_kernel (quant=True: the
// quant epilogue and requant at :373-394), reached through
// csmri_refinement_tpu/ops/quantize.py::chain_forward_int8 from the U-Net's
// eval chains with quantize_inference set. Per layer:
//
//     acc = conv_same(x, w)                               s8 x s8 -> s32
//     y   = fma(f32(acc), w_scale[co] * act_scale[b], bias)  f32, one rounding
//     y   = y >= 0 ? y : leak * y
//     not last: y is written in f32 with the image's max |y| (atomicMax),
//               then the requant kernel turns it into the next layer's
//               input: s = 127 / max(amax, 1e-8) (one IEEE division),
//               x = clip(rint(y * s), +-127), act_scale = max(amax, 1e-8)
//               * f32(1/127)
//     last:     y is cast to the output type (bf16 or f32)
//
// NHWC x (B, H, W, Cin), Cin a multiple of 32, Cout a multiple of 16,
// k in {3, 4}, SAME pad (1, 1) for k3 and (1, 2) for k4 with reflect,
// replicate or zero padding (int8 zero is the value 0: the quantization
// is symmetric), per-Cout f32 weight scales and bias.
//
// Rounding, kept bit for bit from the plain versions (ops/conv_chain.py):
// the scale product is __fmul_rn, never contracted; the dequant and bias
// are one __fmaf_rn, which is what XLA's CPU backend makes of the JAX
// package's acc * scale + bias; LeakyReLU is __fmul_rn(leak, v); the
// requant divides once (__fdiv_rn) and rounds half to even (rintf), as
// jnp.round does, and the next scale is amax times f32(1/127), which is
// what XLA makes of amax / 127.0 under jit.
//
// What bounds it on the H100: operations. The seven quantized layers of
// the flagship U-Net at 256^2, B = 32, do 412.3 G int8 operations, 0.208 ms
// at 1979 TOP/s; the bytes the work needs (each chain's int8 input,
// weights and bf16 output, 629.7 MB) take 0.188 ms at 3.35 TB/s.
//
// Design: K2's implicit GEMM (csrc/conv_chain.cu) on s8 wgmma.
//   - MMA: wgmma.mma_async m64nNk32.s32.s8.s8, N = all of Cout up to 128,
//     both operands K-major in shared memory (PTX transposes no 8-bit
//     operand; both are K-major already). An output tile is R rows x 64
//     pixels of one image; two warpgroups each own R / 2 rows, one wgmma
//     per row per 32 of K; R / 2 is 4 for N <= 64 and 2 for N = 128.
//   - A from a planar halo: one plane per 16 channels, each pixel row 16
//     bytes (one s8 core-matrix row), 8-pixel core matrices 128 bytes
//     apart (SBO); a k32 step spans two planes, `plane` bytes apart (LBO).
//     A tap (dy, dx) is only the descriptor's start address: no im2col,
//     no A registers. K runs over (chunk, tap, channel in chunk); chunks
//     of 32 channels for k4, and for k3 one chunk of up to 128 channels
//     (rounded up to 32, 64 or 128) or chunks of 128, so that a chunk's
//     k*k*chunk is whole 128-wide stages or the layer has one chunk
//     (ops/conv_chain.py::gemm_layout_int8).
//   - B: the weights packed on the host once per call, K-major (Cout, kp),
//     kp a multiple of 128 (ops/conv_chain.py::pack_weights_int8); a stage
//     is 128 of K for all N, one 128-byte row per output channel, loaded
//     by TMA (tensor map encoded on the host) with the 128-byte swizzle
//     the descriptor names, into a ring of 4 stages on mbarriers, 2 ahead.
//   - Persistent blocks walk the tiles; the halo of the next chunk (or of
//     the next tile) loads with 16-byte cp.async into the second halo
//     buffer behind the current stage's MMAs (zero padding is its zero
//     fill, the other pad modes the source-index map).
//   - Only wgmma writes the accumulators inside the K loop (ptxas keeps
//     the MMA pipe full: no C7517). The epilogue runs from the s32
//     accumulators: f32 outputs as 8-byte stores, bf16 as 16-byte stores
//     after a 4 x 4 transpose within each lane quad. An intermediate
//     layer's max |y| is reduced per warp, then in shared memory, and one
//     atomicMax per block per image goes to device memory.
// The requant is a second, elementwise kernel, 5 bytes a value near the
// HBM rate. Folding it into the next layer's halo staging (f32 loads
// through registers, quantized on the way) measured slower: those loads,
// 4x the int8 bytes, stall a K loop that has too little MMA work in
// flight to hide them (PERF.md §6). The TPU kernel keeps a whole chain
// on chip, which is later work here.

#include <cuda_bf16.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kThreads = 256;  // two warpgroups
constexpr int kTileW = 64;     // output pixels per tile row: one wgmma M
constexpr int kKStage = 128;   // K per weight stage: one 128-byte row
constexpr int kRing = 4, kAhead = kRing - 2;

// Keeps the compiler from moving accumulator uses across wgmma syncs.
template <int MT, int NA>
__device__ __forceinline__ void fence_acc(int (&d)[MT][NA]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < NA; ++i) asm volatile("" : "+r"(d[m][i])::"memory");
}

// D(64 x N, s32) = A(64 x 32, s8) * B(32 x N, s8) + D, or + 0 when kstep
// is 0 (a tile's first k32 step); A and B in shared memory.
template <int N>
struct Wgmma;

#define ACC8(o) "+r"(d[o]), "+r"(d[o + 1]), "+r"(d[o + 2]), "+r"(d[o + 3]), \
    "+r"(d[o + 4]), "+r"(d[o + 5]), "+r"(d[o + 6]), "+r"(d[o + 7])

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void mma(int (&d)[8], uint64_t ad,
                                             uint64_t bd, int kstep) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p;\n}\n"
        : ACC8(0)
        : "l"(ad), "l"(bd), "r"(kstep));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(int (&d)[16], uint64_t ad,
                                             uint64_t bd, int kstep) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p;\n}\n"
        : ACC8(0), ACC8(8)
        : "l"(ad), "l"(bd), "r"(kstep));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(int (&d)[32], uint64_t ad,
                                             uint64_t bd, int kstep) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p;\n}\n"
        : ACC8(0), ACC8(8), ACC8(16), ACC8(24)
        : "l"(ad), "l"(bd), "r"(kstep));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(int (&d)[64], uint64_t ad,
                                             uint64_t bd, int kstep) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
        : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40),
          ACC8(48), ACC8(56)
        : "l"(ad), "l"(bd), "r"(kstep));
  }
};

#undef ACC8

struct Args {
  const int8_t* x;      // (B, H, W, Cin)
  const float* scale;   // (B,) act scales
  const int8_t* wp;     // (Cout, kp) packed weights
  const float* w_scale; // (Cout,)
  const float* bias;    // (Cout,)
  void* y;              // (B, H, W, Cout), bf16 or f32
  unsigned* amax;       // (B,) max |y| as float bits, or null
  int batch, h, w, cin, cout;
  int cc_log2;  // log2 of the channels per halo chunk (32, 64 or 128)
  int chunks;   // halo chunks: padded Cin / chunk
  int ktot;     // taps x padded Cin
  int kp;       // ktot rounded up to kKStage
  int pad_mode, has_leak, out_bf16;
  float leak;
};

template <int K, int MT>
struct Tile {
  static constexpr int R = 2 * MT;  // output rows per tile
  static constexpr int kHaloW = kTileW + K - 1;
  static constexpr int kHaloH = R + K - 1;
  static constexpr int kPix = kHaloH * kHaloW;
  // one plane per 16 channels: kPix rows of 16 bytes, 128-byte aligned
  static constexpr int kPlane = (kPix * 16 + 127) / 128 * 128;
};

struct TileAt {
  int img, oy0, ox0, n0;
};

// Output tile t: channel blocks vary fastest (blocks that run together
// share their halo in L2), then columns, rows and images.
template <int K, int N, int MT>
__device__ __forceinline__ TileAt tile_at(const Args& a, int t) {
  const int nblk = a.cout / N;
  const int tiles_w = (a.w + kTileW - 1) / kTileW;
  const int tiles_h = (a.h + Tile<K, MT>::R - 1) / Tile<K, MT>::R;
  TileAt r;
  r.n0 = (t % nblk) * N;
  t /= nblk;
  r.ox0 = (t % tiles_w) * kTileW;
  t /= tiles_w;
  r.oy0 = (t % tiles_h) * Tile<K, MT>::R;
  r.img = t / tiles_h;
  return r;
}

// Persistent: each block walks the tiles blockIdx.x, + gridDim.x, ...; its
// K stages form one stream across tiles, so the next tile's halo and
// weights load while the current tile runs its MMAs and epilogue. Two
// blocks per SM when the accumulators take at most 64 registers.
template <int K, int N, int MT>
__global__ void __launch_bounds__(kThreads, MT * N <= 128 ? 2 : 1)
conv_int8_kernel(const Args a, int ntiles,
                 const __grid_constant__ CUtensorMap wmap) {
  using TL = Tile<K, MT>;
  constexpr int T = K * K, kPadT = (K - 1) / 2, NA = N / 2;
  constexpr int HW = TL::kHaloW;
  extern __shared__ unsigned char smem_raw[];
  // the swizzled weight stages want 1024-byte alignment
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sbase = smem_raw + (base - raw);
  const uint32_t ring = base;
  const uint32_t halo0 = base + kRing * N * 128;
  const int cc = 1 << a.cc_log2;
  const int G = cc >> 4;                   // planes per chunk
  const int halo_bytes = G * TL::kPlane;
  const uint32_t wbar = halo0 + 2 * halo_bytes;  // an mbarrier per slot
  unsigned* blk_max = reinterpret_cast<unsigned*>(
      sbase + (wbar + 8 * kRing - base));
  const int span = T * cc;                 // K per halo chunk
  const int stages = a.kp / kKStage;       // per tile
  const int my_tiles = (ntiles - (int)blockIdx.x + (int)gridDim.x - 1) /
                       (int)gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wq = warp & 3;

  // Byte offset of plane j (channels 16 j .. 16 j + 15 of the chunk) of
  // halo pixel p: the 64 pixels of an A tile are 1 KB of consecutive rows.
  auto halo_at = [&](int p, int j) {
    return (uint32_t)(j * TL::kPlane + (p << 4));
  };

  // Stage g of this block's stream of weight stages into its ring slot
  // (thread 0).
  auto load_weights = [&](int g) {
    if (g >= my_tiles * stages) return;
    const int lt = g / stages, slot = g % kRing;
    const int n0 = tile_at<K, N, MT>(a, blockIdx.x + lt * gridDim.x).n0;
    mbar_expect(wbar + 8 * slot, N * 128);
    tma_load_2d(ring + slot * N * 128, &wmap, (g - lt * stages) * kKStage, n0,
                wbar + 8 * slot);
  };

  // Halo chunk c of local tile lt into halo buffer `buf`, by all threads,
  // 16-byte cp.async: zeros past Cin and in zero padding.
  auto load_halo = [&](int lt, int c, int buf) {
    if (lt >= my_tiles) return;
    const TileAt tl = tile_at<K, N, MT>(a, blockIdx.x + lt * gridDim.x);
    const uint32_t hdst = halo0 + buf * halo_bytes;
    const int8_t* xb = a.x + (size_t)tl.img * a.h * a.w * a.cin;
    for (int i = tid; i < TL::kPix * G; i += kThreads) {
      const int p = i >> (a.cc_log2 - 4), j = i & (G - 1);
      const int hy = p / HW, hx = p - hy * HW;
      const int sy = pad_index(tl.oy0 + hy - kPadT, a.h, a.pad_mode);
      const int sx = pad_index(tl.ox0 + hx - kPadT, a.w, a.pad_mode);
      const int ch = c * cc + j * 16;
      const bool ok = sy >= 0 && sx >= 0 && ch < a.cin;
      const size_t src = ((size_t)sy * a.w + sx) * a.cin + ch;
      cp_async16(hdst + halo_at(p, j), ok ? xb + src : a.x, ok ? 16 : 0);
    }
    cp_async_commit();
  };

  int acc[MT][NA];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[mt][i] = 0;

  if (tid == 0) {
    for (int i = 0; i < kRing; ++i) mbar_init(wbar + 8 * i);
    *blk_max = 0u;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  load_halo(0, 0, 0);
  if (tid == 0)
    for (int g = 0; g < kAhead; ++g) load_weights(g);

  const int g4 = lane >> 2, t4 = lane & 3;

  // Cursors of the MMA side: the stage in the block's stream, the chunk in
  // it (its halo buffer is gc & 1), the K offset within the chunk, the
  // chunk within the tile.
  int gs = 0, gc = 0, rem = 0, c = 0;
#pragma unroll 1
  for (int lt = 0; lt < my_tiles; ++lt) {
    // The K loop of one tile. Only wgmma writes the accumulators in it
    // (the tile's first MMA of each row scales them by 0), so the
    // compiler can keep MMAs in flight across its iterations.
#pragma unroll 1
    for (int s = 0; s < stages; ++s, ++gs) {
      if (rem == 0) cp_async_wait<0>();  // the chunk's halo
      mbar_wait(wbar + 8 * (gs % kRing), (gs / kRing) & 1);
      fence_proxy_async();
      // every thread is past stage s - 2's MMAs, so its weight slot takes
      // stage s + kAhead, and from the chunk's second stage on the other
      // halo buffer is free (its chunk's last stage is done)
      __syncthreads();
      if (tid == 0) load_weights(gs + kAhead);

      const int kleft = (a.ktot - s * kKStage) >> 5;  // k32 steps left
      const uint32_t hb = halo0 + (gc & 1) * halo_bytes;
      const uint64_t desc = b_desc(ring + (gs % kRing) * N * 128);
      wgmma_fence();
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (q < kleft) {
          // A of k32 step q: tap (dy, dx), planes j and j + 1; row mt of
          // this warpgroup reads 64 pixels from halo row wg * MT + mt +
          // dy, column dx: HW pixels (HW x 16 bytes) per row, and the
          // descriptor's address field counts 16 bytes. B: 32 bytes on
          // per k32.
          const int rq = rem + q * 32;
          const int tap = rq >> a.cc_log2;
          const int j = (rq & (cc - 1)) >> 4;
          const int dy = tap / K, pix = dy * HW + tap - dy * K;
          const uint64_t ad =
              a_desc(hb + halo_at(wg * MT * HW + pix, j), TL::kPlane);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            Wgmma<N>::mma(acc[mt], ad + mt * HW, desc + 2 * q, s + q);
        }
      }
      wgmma_commit();
      fence_acc<MT, NA>(acc);
      // the next chunk's halo, issued behind this stage's MMAs
      if (rem == kKStage) {
        if (c + 1 < a.chunks) load_halo(lt, c + 1, (gc + 1) & 1);
        else load_halo(lt + 1, 0, (gc + 1) & 1);
      }
      wgmma_wait<1>();

      rem += kKStage;
      if (rem >= span) {
        rem = 0;
        ++c;
        ++gc;
      }
    }
    // Epilogue from the accumulator registers. Accumulator i of this lane:
    // pixel g4 (+8 if i & 2), channel 8 (i / 4) + 2 t4 + (i & 1).
    wgmma_wait<0>();
    fence_acc<MT, NA>(acc);
    const TileAt tl = tile_at<K, N, MT>(a, blockIdx.x + lt * gridDim.x);
    const float as = __ldg(a.scale + tl.img);
    float local_max = 0.f;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int oy = tl.oy0 + wg * MT + mt;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int ox = tl.ox0 + wq * 16 + g4 + 8 * half;
        const bool ok = oy < a.h && ox < a.w;
        const size_t at = (((size_t)tl.img * a.h + oy) * a.w + ox) * a.cout +
                          tl.n0;
        float v[N / 4];  // channels 8 j + 2 t4 + e at 2 j + e
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
          const int n = tl.n0 + 8 * j + 2 * t4;
          const float2 ws =
              __ldg(reinterpret_cast<const float2*>(a.w_scale + n));
          const float2 bs = __ldg(reinterpret_cast<const float2*>(a.bias + n));
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float r = __fmaf_rn(__int2float_rn(acc[mt][4 * j + 2 * half + e]),
                                __fmul_rn(e ? ws.y : ws.x, as),
                                e ? bs.y : bs.x);
            if (a.has_leak && !(r >= 0.f)) r = __fmul_rn(a.leak, r);
            v[2 * j + e] = r;
            if (ok) local_max = fmaxf(local_max, fabsf(r));
          }
        }
        if (!a.out_bf16) {
          float* dst = reinterpret_cast<float*>(a.y) + at;
#pragma unroll
          for (int j = 0; j < N / 8; ++j)
            if (ok)
              *reinterpret_cast<float2*>(dst + 8 * j + 2 * t4) =
                  make_float2(v[2 * j], v[2 * j + 1]);
          continue;
        }
        uint32_t pk[N / 8];
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
          const __nv_bfloat162 b2 = __floats2bfloat162_rn(v[2 * j],
                                                          v[2 * j + 1]);
          pk[j] = *reinterpret_cast<const uint32_t*>(&b2);
        }
        __nv_bfloat16* dst = reinterpret_cast<__nv_bfloat16*>(a.y) + at;
        if constexpr (N % 32 == 0) {
          // Transpose 4 x 4 words within the quad: lane t4 then holds the
          // 8 channels 8 (4 jq + t4) .. + 7 of its pixel.
#pragma unroll
          for (int jq = 0; jq < N / 32; ++jq) {
            uint32_t r[4], w1[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const uint32_t got =
                  __shfl_xor_sync(0xffffffffu, pk[4 * jq + (e ^ 1)], 1);
              w1[e] = (e & 1) != (t4 & 1) ? got : pk[4 * jq + e];
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const uint32_t got = __shfl_xor_sync(0xffffffffu, w1[e ^ 2], 2);
              r[e] = (e & 2) != (t4 & 2) ? got : w1[e];
            }
            if (ok)
              *reinterpret_cast<uint4*>(dst + 8 * (4 * jq + t4)) =
                  make_uint4(r[0], r[1], r[2], r[3]);
          }
        } else {
#pragma unroll
          for (int j = 0; j < N / 8; ++j)
            if (ok) *reinterpret_cast<uint32_t*>(dst + 8 * j + 2 * t4) = pk[j];
        }
      }
    }
    if (a.amax != nullptr) {
      // max |y| of the tile: per warp, then per block in shared memory;
      // one atomicMax per block and image, when the block's next tile is
      // of another image or it has none (non-negative floats order as
      // their bits)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        local_max =
            fmaxf(local_max, __shfl_xor_sync(0xffffffffu, local_max, off));
      if (lane == 0) atomicMax(blk_max, __float_as_uint(local_max));
      const bool flush =
          lt + 1 == my_tiles ||
          tile_at<K, N, MT>(a, blockIdx.x + (lt + 1) * gridDim.x).img !=
              tl.img;
      if (flush) {
        __syncthreads();
        if (tid == 0) {
          atomicMax(a.amax + tl.img, *blk_max);
          *blk_max = 0u;
        }
      }
    }
    c = 0;  // the last stage moved gc on to the next tile's chunk 0
  }
  cp_async_wait<0>();
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

template <int K, int N, int MT>
int launch(const Args& ga, cudaStream_t st) {
  using TL = Tile<K, MT>;
  auto kern = conv_int8_kernel<K, N, MT>;
  // weights: (Cout, kp) bytes; a stage is a 128 x N box, stored with the
  // 128-byte swizzle the wgmma descriptor names
  CUtensorMap wmap;
  if (!weight_map(&wmap, ga.wp, ga.kp, ga.cout, kKStage, N,
                  CU_TENSOR_MAP_DATA_TYPE_UINT8, 1))
    return (int)cudaErrorInvalidValue;
  const int planes = (1 << ga.cc_log2) / 16;
  const int smem = 1024 + kRing * N * 128 + 2 * planes * TL::kPlane +
                   8 * kRing + 16;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long ntiles = (long)((ga.h + TL::R - 1) / TL::R) *
                      ((ga.w + kTileW - 1) / kTileW) * ga.batch *
                      (ga.cout / N);
  if (ntiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const long fit = (long)per_sm * sms;
  const unsigned grid = (unsigned)(ntiles < fit ? ntiles : fit);
  kern<<<grid, kThreads, smem, st>>>(ga, (int)ntiles, wmap);
  return (int)cudaGetLastError();
}

template <int K>
int launch_n(const Args& ga, cudaStream_t st) {
  if (ga.cout % 128 == 0) return launch<K, 128, 2>(ga, st);
  if (ga.cout % 64 == 0) return launch<K, 64, 4>(ga, st);
  if (ga.cout % 32 == 0) return launch<K, 32, 4>(ga, st);
  return launch<K, 16, 4>(ga, st);
}

// Padded Cin and halo chunk (ops/conv_chain.py::gemm_layout_int8): k4
// takes 32-channel chunks (16 x 32 = 4 stages of 128). A k3 chunk of 32
// spans 288 of K, not whole stages, so k3 runs one chunk of Cin rounded up
// to 32, 64 or 128 (its last stage partial), or chunks of 128 (9 stages).
void gemm_layout(int cin, int k, int* cc_log2, int* chunks, int* ktot,
                 int* kp) {
  const int cc = (k == 4 || cin <= 32) ? 32 : cin <= 64 ? 64 : 128;
  const int pad = (cin + cc - 1) / cc * cc;
  *cc_log2 = cc == 32 ? 5 : cc == 64 ? 6 : 7;
  *chunks = pad / cc;
  *ktot = k * k * pad;
  *kp = (*ktot + kKStage - 1) / kKStage * kKStage;
}

}  // namespace

// x: (batch, h, w, cin) int8 with act scales `scale` (batch,) f32; wt: the
// packed (cout, kp) int8 weights of ops/conv_chain.py::pack_weights_int8,
// kp its row length (checked); w_scale, bias: (cout,) f32; y: (batch, h,
// w, cout) in bf16 if out_bf16 else f32; amax: (batch,) uint32 zeroed by
// the caller (max |y| per image is atomicMax-ed into it as float bits), or
// null. x, wt and y 16-byte aligned, w_scale and bias 8-byte. pad_mode: 0
// zero, 1 reflect, 2 replicate. Launches on `stream`; returns
// cudaGetLastError() after it.
extern "C" int conv_layer_int8(const void* x, const void* scale,
                               const void* wt, int kp, const void* w_scale,
                               const void* bias, void* y, void* amax,
                               int batch, int h, int w, int cin, int cout,
                               int k, int pad_mode, int out_bf16,
                               int has_leak, float leak, void* stream) {
  if (batch < 1 || batch > 65535 || h < 1 || w < 1 || cin < 32 ||
      cin % 32 || cout < 16 || cout % 16 || pad_mode < 0 || pad_mode > 2 ||
      (k != 3 && k != 4) || ((uintptr_t)x | (uintptr_t)wt | (uintptr_t)y) %
                                16 ||
      ((uintptr_t)w_scale | (uintptr_t)bias) % 8 ||
      (pad_mode == kReflect && (h < 2 || w < 2))) {
    return (int)cudaErrorInvalidValue;
  }
  Args ga;
  ga.x = (const int8_t*)x;
  ga.scale = (const float*)scale;
  ga.wp = (const int8_t*)wt;
  ga.w_scale = (const float*)w_scale;
  ga.bias = (const float*)bias;
  ga.y = y;
  ga.amax = (unsigned*)amax;
  ga.batch = batch;
  ga.h = h;
  ga.w = w;
  ga.cin = cin;
  ga.cout = cout;
  int want_kp = 0;
  gemm_layout(cin, k, &ga.cc_log2, &ga.chunks, &ga.ktot, &want_kp);
  if (kp != want_kp) return (int)cudaErrorInvalidValue;
  ga.kp = kp;
  ga.pad_mode = pad_mode;
  ga.has_leak = has_leak;
  ga.out_bf16 = out_bf16;
  ga.leak = leak;
  cudaStream_t st = (cudaStream_t)stream;
  if (k == 3) return launch_n<3>(ga, st);
  return launch_n<4>(ga, st);
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
