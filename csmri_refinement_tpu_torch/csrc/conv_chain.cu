// One SAME stride-1 conv layer of a fused conv chain, for Hopper (sm_90a).
//
// Replaces the float mode of the TPU kernel
// csmri_refinement_tpu/ops/conv_pallas.py::_chain_kernel (wrapper
// fused_conv_chain, reached by chain_forward from the U-Net's eval-mode
// ConvEncodeUnit chains): per layer
//
//     y = act(conv_same(x, w) + bias)     act = LeakyReLU or identity
//
// NHWC x (B, H, W, Cin), k in {3, 4}, BN already folded into w and the f32
// bias; SAME pad (1, 1) for k3 and (1, 2) for k4 with reflect, replicate or
// zero padding, exact at every border; f32 accumulation; the result is
// cast to the compute type (bf16 or f32), which is the rounding of
// intermediates in conv_pallas.py:386-388.
//
// What bounds it on the H100: operations. A flagship U-Net layer does
// 2*k*k*Cin*Cout flops per pixel (16-32 K) against 2*(Cin+Cout) bytes of
// bf16 activations: far above the ~295 flop/B ridge of bf16.
//
// bf16 (the main path): an implicit GEMM on the tensor cores with wgmma.
// An output tile is R rows x 64 columns of one image by N = all of Cout
// up to 128, so each input halo is read once per tile. M = pixels, N =
// output channels, K = taps x Cin in the order (Cin chunk, tap, channel
// in chunk). Two warpgroups each own R / 2 rows: one m64nNk16 wgmma per
// row, per 16 of K. R / 2 is 4 for Cout <= 64 and 2 for 128: each
// warpgroup holds 64 (two blocks on an SM) or 128 f32 accumulators, and
// each barrier of the K loop is shared by 4 x R / 2 wgmmas per warpgroup
// (two rows per warpgroup measured up to 1.4x slower).
//   - A from shared memory: the halo is stored as planes, one per 8
//     channels, of 16-byte pixel rows, so the 64 pixels of a row at any
//     tap (dy, dx) are one K-major no-swizzle wgmma tile (8-pixel core
//     matrices 128 bytes apart, the next 8 channels one plane on): a
//     tap's shift is only the descriptor's start address, and nothing is
//     copied per tap (no im2col, no ldmatrix, no A registers).
//   - B from shared memory: the wrapper packs the weights once per call,
//     K-major (Cout, K) with K padded to 64 (ops/conv_chain.py::
//     pack_weights); a stage is 64 of K for all N, one 128-byte row per
//     output channel, stored with the 128-byte swizzle the wgmma
//     descriptor names.
//   - Staging: persistent blocks walk tiles; the K stages of all their
//     tiles form one stream. A ring of 4 weight stages is filled by TMA
//     (one thread issues a 64 x N box per stage, the tensor map built on
//     the host, completion on an mbarrier per slot) two stages ahead of
//     the MMAs. The halo of the next chunk (or the next tile's first
//     chunk) loads with 16-byte cp.async into the second of two halo
//     buffers from the second stage of the current chunk on, once the
//     MMAs that read that buffer are done; zero padding is cp.async's
//     zero fill, the other pad modes the source-index map (pad_index).
//     (A TMA box per halo plane measured slower: its 16-byte rows.) Halo
//     chunks are 16 channels for Cin <= 16, else 32, or 64 for k3
//     (ops/conv_chain.py::gemm_layout).
//   - Routes, by shape (ops/conv_chain.py::conv_route): Cin % 8 == 0 stages
//     16-byte groups ("wgmma"); other even Cin 4-byte channel pairs
//     ("wgmma, 4-byte staging": the 2-channel stem, whose pad channels
//     are zeroed once); odd Cin is gathered by the threads ("wgmma,
//     gathered halo").
//   - The epilogue runs from the accumulator registers: + bias, LeakyReLU,
//     bf16, a 4x4 transpose within each lane quad, 16-byte stores.
// f32 is csrc/conv_f32.cu (3xTF32). One launch per layer: keeping a whole
// chain on chip is later work.

#include <cuda_bf16.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

// --- bf16: wgmma implicit GEMM -----------------------------------------

constexpr int kGemmThreads = 256;  // two warpgroups
constexpr int kTileW = 64;         // output columns per tile: one wgmma M
constexpr int kKStage = 64;        // K per stage: one 128-byte row
// Weight stages in shared memory, N x 128 bytes each; kAhead of them load
// ahead of the MMAs (a deeper ring measured no faster).
constexpr int kRing = 4, kAhead = kRing - 2;

// 4-byte copy; `bytes` 0 writes zeros.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
// Keeps the compiler from moving accumulator uses across wgmma syncs.
template <int MT, int NA>
__device__ __forceinline__ void fence_acc(float (&d)[MT][NA]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < NA; ++i) asm volatile("" : "+f"(d[m][i])::"memory");
}

// D(64 x N, f32) = A(64 x 16, bf16) * B(16 x N, bf16) + D, or + 0 when
// kstep is 0 (a tile's first k16 step); A and B in shared memory.
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void mma(float (&d)[8],
                                             uint64_t adesc, uint64_t bdesc,
                                             int kstep) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, "
        "%8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(adesc), "l"(bdesc), "r"(kstep));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float (&d)[16],
                                             uint64_t adesc, uint64_t bdesc,
                                             int kstep) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(adesc), "l"(bdesc), "r"(kstep));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32],
                                             uint64_t adesc, uint64_t bdesc,
                                             int kstep) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(adesc), "l"(bdesc), "r"(kstep));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64],
                                             uint64_t adesc, uint64_t bdesc,
                                             int kstep) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(adesc), "l"(bdesc), "r"(kstep));
  }
};

struct GemmArgs {
  const __nv_bfloat16* x;   // (B, H, W, Cin)
  const __nv_bfloat16* wp;  // (Cout, kp) packed weights
  const float* bias;        // (Cout,)
  __nv_bfloat16* y;         // (B, H, W, Cout)
  int batch, h, w, cin, cout;
  int cc_log2;  // log2 of the channels per halo chunk (16, 32 or 64)
  int chunks;   // halo chunks: padded Cin / chunk
  int ktot;     // taps x padded Cin
  int kp;       // ktot rounded up to kKStage
  int pad_mode, has_leak;
  int stage;    // halo staging: 0 16-byte, 1 4-byte copies, 2 gathered
  float leak;
};

template <int K, int MT>
struct GemmTile {
  static constexpr int R = 2 * MT;  // output rows per tile
  static constexpr int kHaloW = kTileW + K - 1;
  static constexpr int kHaloH = R + K - 1;
  static constexpr int kPix = kHaloH * kHaloW;
  // one plane per 8 channels: kPix rows of 16 bytes, 128-byte aligned
  static constexpr int kPlane = (kPix * 16 + 127) / 128 * 128;
};

// Output tile `t` of the layer: image, top row, left column, first output
// channel. Channel blocks vary fastest, so blocks that run together share
// their halo in L2.
struct TileAt {
  int img, oy0, ox0, n0;
};

template <int K, int N, int MT>
__device__ __forceinline__ TileAt tile_at(const GemmArgs& a, int t) {
  const int nblk = a.cout / N;
  const int tiles_w = (a.w + kTileW - 1) / kTileW;
  const int tiles_h = (a.h + GemmTile<K, MT>::R - 1) / GemmTile<K, MT>::R;
  TileAt r;
  r.n0 = (t % nblk) * N;
  t /= nblk;
  r.ox0 = (t % tiles_w) * kTileW;
  t /= tiles_w;
  r.oy0 = (t % tiles_h) * GemmTile<K, MT>::R;
  r.img = t / tiles_h;
  return r;
}

// Persistent: each block walks the tiles blockIdx.x, + gridDim.x, ...; its
// K stages form one stream across tiles, so the next tile's halo and
// weights load while the current tile runs its MMAs and epilogue.
// Two blocks per SM when the accumulators take at most 64 registers.
template <int K, int N, int MT>
__global__ void __launch_bounds__(kGemmThreads, MT * N <= 128 ? 2 : 1)
conv_wgmma_kernel(const GemmArgs a, int ntiles,
                  const __grid_constant__ CUtensorMap wmap) {
  using TL = GemmTile<K, MT>;
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
  const int G = cc >> 3;                   // 16-byte groups per pixel
  const int halo_bytes = G * TL::kPlane;
  const uint32_t wbar = halo0 + 2 * halo_bytes;  // an mbarrier per slot
  const int span = T * cc;                 // K per halo chunk
  const int stages = a.kp / kKStage;       // per tile
  const int my_tiles = (ntiles - (int)blockIdx.x + (int)gridDim.x - 1) /
                       (int)gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wq = warp & 3;

  // Byte offset of 16-byte channel group j of halo pixel p: one plane per
  // group, so the 64 pixels of an A tile are 1 KB of consecutive rows.
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

  // Halo chunk c of local tile lt into halo buffer `buf`, by all threads.
  auto load_halo = [&](int lt, int c, int buf) {
    if (lt >= my_tiles) return;
    const TileAt tl = tile_at<K, N, MT>(a, blockIdx.x + lt * gridDim.x);
    const uint32_t hdst = halo0 + buf * halo_bytes;
    const __nv_bfloat16* xb = a.x + (size_t)tl.img * a.h * a.w * a.cin;
    // even Cin in one chunk (the stem) copies only the channels it has:
    // the others were zeroed once
    const bool zeroed = a.stage == 1 && a.chunks == 1;
    const int gr = zeroed ? (a.cin + 7) >> 3 : G;
    for (int i = tid; i < TL::kPix * G; i += kGemmThreads) {
      const int p = i >> (a.cc_log2 - 3), j = i & (G - 1);
      if (j >= gr) continue;
      const int hy = p / HW, hx = p - hy * HW;
      const int sy = pad_index(tl.oy0 + hy - kPadT, a.h, a.pad_mode);
      const int sx = pad_index(tl.ox0 + hx - kPadT, a.w, a.pad_mode);
      const bool in = sy >= 0 && sx >= 0;
      const int ch = c * cc + j * 8;
      const size_t src = ((size_t)sy * a.w + sx) * a.cin + ch;
      const uint32_t dst = hdst + halo_at(p, j);
      if (a.stage == 0) {  // Cin % 8 == 0: whole groups, zeros past Cin
        const bool ok = in && ch < a.cin;
        cp_async16(dst, ok ? xb + src : a.x, ok ? 16 : 0);
      } else if (a.stage == 1) {  // even Cin: channel pairs, zero-filled
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool real = ch + 2 * e < a.cin;
          if (!real && zeroed) break;
          const bool ok = in && real;
          cp_async4(dst + 4 * e, ok ? xb + src + 2 * e : a.x, ok ? 4 : 0);
        }
      } else {  // odd Cin: gathered by the threads
        const unsigned short* xs = reinterpret_cast<const unsigned short*>(xb);
        uint32_t v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t lo =
              in && ch + 2 * e < a.cin ? xs[src + 2 * e] : 0u;
          const uint32_t hi =
              in && ch + 2 * e + 1 < a.cin ? xs[src + 2 * e + 1] : 0u;
          v[e] = lo | hi << 16;
        }
        *reinterpret_cast<uint4*>(sbase + (dst - base)) =
            make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
    cp_async_commit();
  };

  float acc[MT][NA];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[mt][i] = 0.f;

  if (tid == 0) {
    for (int i = 0; i < kRing; ++i) mbar_init(wbar + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (a.stage == 1 && a.chunks == 1) {  // zero the stem's pad channels once
    uint4* hz = reinterpret_cast<uint4*>(sbase + (halo0 - base));
    for (int i = tid; i < 2 * halo_bytes / 16; i += kGemmThreads)
      hz[i] = make_uint4(0u, 0u, 0u, 0u);
    fence_proxy_async();
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

      const int kleft = (a.ktot - s * kKStage) >> 4;  // k16 steps left
      const uint32_t hb = halo0 + (gc & 1) * halo_bytes;
      const uint64_t desc = b_desc(ring + (gs % kRing) * N * 128);
      wgmma_fence();
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (q < kleft) {
          // A of k16 step q: tap (dy, dx), channel groups j and j + 1;
          // row mt of this warpgroup reads 64 pixels from halo row
          // wg * MT + mt + dy, column dx: HW pixels (HW x 16 bytes) per
          // row, and the descriptor's address field counts 16 bytes. B:
          // 32 bytes on per k16.
          const int rq = rem + q * 16;
          const int tap = rq >> a.cc_log2;
          const int j = (rq & (cc - 1)) >> 3;
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
    // row g4 (+8 if i & 2), channel 8 (i / 4) + 2 t4 + (i & 1).
    wgmma_wait<0>();
    fence_acc<MT, NA>(acc);
    const TileAt tl = tile_at<K, N, MT>(a, blockIdx.x + lt * gridDim.x);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int oy = tl.oy0 + wg * MT + mt;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int ox = tl.ox0 + wq * 16 + g4 + 8 * half;
        uint32_t pk[N / 8];
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
          const float2 bv = __ldg(reinterpret_cast<const float2*>(
              a.bias + tl.n0 + 8 * j + 2 * t4));
          float v0 = acc[mt][4 * j + 2 * half] + bv.x;
          float v1 = acc[mt][4 * j + 2 * half + 1] + bv.y;
          if (a.has_leak) {
            if (v0 < 0.f) v0 *= a.leak;
            if (v1 < 0.f) v1 *= a.leak;
          }
          const __nv_bfloat162 b2 = __floats2bfloat162_rn(v0, v1);
          pk[j] = *reinterpret_cast<const uint32_t*>(&b2);
        }
        const bool ok = oy < a.h && ox < a.w;
        __nv_bfloat16* dst =
            a.y + (((size_t)tl.img * a.h + oy) * a.w + ox) * a.cout + tl.n0;
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
    c = 0;  // the last stage moved gc on to the next tile's chunk 0
  }
  cp_async_wait<0>();
}

template <int K, int N, int MT>
int launch_wgmma(const GemmArgs& ga, cudaStream_t st) {
  using TL = GemmTile<K, MT>;
  auto kern = conv_wgmma_kernel<K, N, MT>;
  // weights: (Cout, kp); a stage is a 64 x N box, stored with the 128-byte
  // swizzle the wgmma descriptor names
  CUtensorMap wmap;
  if (!weight_map(&wmap, ga.wp, ga.kp * 2, ga.cout, kKStage * 2, N,
                  CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2))
    return (int)cudaErrorInvalidValue;
  const int groups = (1 << ga.cc_log2) / 8;  // halo planes
  const int smem = 1024 + kRing * N * 128 + 2 * groups * TL::kPlane +
                   8 * kRing;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                      kGemmThreads, smem);
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
  kern<<<grid, kGemmThreads, smem, st>>>(ga, (int)ntiles, wmap);
  return (int)cudaGetLastError();
}

template <int K>
int launch_wgmma_n(const GemmArgs& ga, cudaStream_t st) {
  if (ga.cout % 128 == 0) return launch_wgmma<K, 128, 2>(ga, st);
  if (ga.cout % 64 == 0) return launch_wgmma<K, 64, 4>(ga, st);
  if (ga.cout % 32 == 0) return launch_wgmma<K, 32, 4>(ga, st);
  return launch_wgmma<K, 16, 4>(ga, st);
}

// Padded Cin and halo chunk of the bf16 route (ops/conv_chain.py::
// gemm_layout): Cin up to 16 pads to 16 and is one chunk. Above, 32-channel
// chunks (a small halo leaves room for two blocks on an SM); but a k3
// chunk of 32 spans 288 of K, not a whole number of 64-wide stages, so k3
// layers of more than one chunk take 64-channel chunks (576).
void gemm_layout(int cin, int k, int* cc_log2, int* chunks, int* ktot,
                 int* kp) {
  const int cc = cin <= 16 ? 16 : (k == 4 || cin <= 32) ? 32 : 64;
  const int pad = (cin + cc - 1) / cc * cc;
  *cc_log2 = cc == 16 ? 4 : cc == 32 ? 5 : 6;
  *chunks = pad / cc;
  *ktot = k * k * pad;
  *kp = (*ktot + kKStage - 1) / kKStage * kKStage;
}

}  // namespace

// x: (batch, h, w, cin), y: (batch, h, w, cout), contiguous bf16; cout a
// multiple of 16 (the wrapper pads other Couts with zero output channels);
// bias: (cout,) f32; wt is the packed (cout, kp) weight of
// ops/conv_chain.py::pack_weights, kp its row length (checked), x, wt and y
// 16-byte aligned. pad_mode: 0 zero, 1 reflect, 2 replicate. Launches on
// `stream`; returns cudaGetLastError() after it.
extern "C" int conv_layer(const void* x, const void* wt, const void* bias,
                          void* y, int batch, int h, int w, int cin, int cout,
                          int k, int kp, int pad_mode, int has_leak,
                          float leak, void* stream) {
  if (batch < 1 || batch > 65535 || h < 1 || w < 1 || cin < 1 || cout < 16 ||
      cout % 16 || cout / 16 > 65535 || pad_mode < 0 || pad_mode > 2 ||
      (k != 3 && k != 4) || (uintptr_t)wt % 16 ||
      (pad_mode == kReflect && (h < 2 || w < 2))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  GemmArgs ga;
  ga.batch = batch;
  ga.x = (const __nv_bfloat16*)x;
  ga.wp = (const __nv_bfloat16*)wt;
  ga.bias = (const float*)bias;
  ga.y = (__nv_bfloat16*)y;
  ga.h = h;
  ga.w = w;
  ga.cin = cin;
  ga.cout = cout;
  int want_kp = 0;
  gemm_layout(cin, k, &ga.cc_log2, &ga.chunks, &ga.ktot, &want_kp);
  if (kp != want_kp || (uintptr_t)x % 16 || (uintptr_t)y % 16)
    return (int)cudaErrorInvalidValue;
  ga.kp = kp;
  ga.pad_mode = pad_mode;
  ga.has_leak = has_leak;
  ga.leak = leak;
  ga.stage = cin % 8 == 0 ? 0 : cin % 2 == 0 ? 1 : 2;
  if (k == 3) return launch_wgmma_n<3>(ga, st);
  return launch_wgmma_n<4>(ga, st);
}
