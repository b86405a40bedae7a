// One SAME stride-1 conv layer in full f32, for Hopper (sm_90a): the f32
// route of the conv chain (ops/conv_chain.py::conv_layer_cuda).
//
// Replaces the float mode of the TPU kernel
// csmri_refinement_tpu/ops/conv_pallas.py::_chain_kernel (wrapper
// fused_conv_chain) for f32 tensors, one layer per launch:
//
//     y = act(conv_same(x, w) + bias)     act = LeakyReLU or identity
//
// NHWC f32 x (B, H, W, Cin), k in {3, 4}, BN folded into w and the bias;
// SAME pad (1, 1) for k3 and (1, 2) for k4 with zero, reflect or replicate
// padding; f32 accumulation. The port holds this route to the JAX CPU
// reference, which is exact f32, so it keeps f32 accuracy.
//
// What bounds it on the H100: operations. A segmentation U-Net layer does
// 2 k^2 Cin Cout flops per pixel against 4 (Cin + Cout) bytes: 72-1152
// flops a byte at Cin 32-512, above the f32 ridge. The CUDA cores' f32 FMA
// peak is 67 TFLOP/s; the tensor cores give 495 TFLOP/s in TF32, which
// keeps 10 of f32's 23 mantissa bits.
//
// 3xTF32 (Cin >= 8, route "3xtf32"): each operand v is split into
// big = tf32(v) and small = tf32(v - big), both rounded to nearest, ties
// away from zero (cvt.rna.tf32.f32's rounding) with their low 13 bits
// cleared, and the product is A_small B_big + A_big B_small + A_big B_big,
// accumulated in f32 by wgmma m64nNk8 .tf32. The dropped A_small B_small
// term is ~2^-22 relative: f32 accuracy at 3 tensor products per MAC, so
// the bound is 3 x the MACs at the TF32 peak. A single TF32 pass would be
// ~2^-11 relative, far above the route's bar.
//   - Implicit GEMM: M = output positions, N = output channels (16-128 per
//     tile), K = taps x Cin in the order (Cin chunk, tap, 16 channels,
//     the channel permutation of A's fragments below). Two warpgroups
//     each own MT m64 tiles of the block's 128 MT positions.
//   - Narrow images: positions are the flattened rows of a column segment
//     of width TW = min(W, 64) padded to the pitch HW = TW + k - 1, so an
//     M tile runs on across image rows; the tap (dy, dx) of position q is
//     halo position q + dy HW + dx. At 16^2 an M tile wastes 2 of every
//     18 positions, where a 64-column tile of one row would waste 48 of
//     64. The (MT, N) of a layer is chosen on the host for the fewest
//     waves of tiles on the card's SMs (launch_gemm_best).
//   - A from registers: the halo of a chunk (16 or 32 channels) is staged
//     raw in f32 by 16-byte cp.async (zero fill for zero padding,
//     pad_index for the others), as planes of 16 channels, 64 bytes a
//     position. A thread's fragment of a k16 group is two 16-byte loads
//     (positions g and g + 8, channels 4 t .. 4 t + 3), conflict-free;
//     the K order puts channel 4 t + 2 s + h of the group at column t + 4 h
//     of k8 step s, so each loaded value lands in its fragment register
//     with no shuffle. The split runs in registers, once per fragment;
//     staging big and small planes in shared memory instead would double
//     the halo and add a pass and a barrier per chunk. The rounding is two
//     integer operations: cvt.rna.tf32.f32 issues at a quarter of their
//     rate, and with it the kernel took 11% longer.
//   - B: the wrapper splits and packs the weights once per call
//     (ops/conv_chain.py::pack_weights_f32): K-major rows of 32 tf32
//     values (128 bytes), the big parts of all Cout rows, then the small
//     parts. A stage is 32 of K for N channels, big and small, loaded by
//     TMA with the 128-byte swizzle that the wgmma descriptor names into
//     a ring of 4 stages, 2 ahead of the MMAs, completion on an mbarrier
//     per slot. (Splitting each staged block in shared memory instead
//     halves the weight bytes but measured 6% slower.)
//   - Pipeline: each k16 group issues 6 wgmmas per m tile; a thread keeps
//     two sets of A fragments and waits with one group in flight, so the
//     next group's loads and splits overlap the MMAs. The next chunk's
//     halo loads into the second buffer behind the MMAs at the chunk's
//     first stage (a share at each stage measured 19% slower). Blocks
//     are persistent and walk tiles, channel blocks fastest.
//   - The tensor cores truncate every f32 addition into an accumulator
//     (round toward zero). Over the 3 K / 8 MMAs of one sum that bias
//     reached ~1e-4 at K = 4608 and failed the 2e-4 bar, so the MMAs of
//     kPromote = 4 stages (48) start from 0 and their sum is added to the
//     tile's sum in registers, rounded to nearest, after the pipe drains
//     (every 2 stages: 2% slower; every 8: 2% faster, 1.4x the error).
//   - Registers: MT x N / 2 accumulators, as many sums, 32 MT fragment
//     registers; MT x N <= 128 (MT = 2, N = 64 spills 24 bytes).
//   - Shared memory (k3, 32-channel chunks, pitch 66): MT = 1, N = 128:
//     halo 262 positions x 128 B = 33.5 KB, twice; ring 4 x 32 KB; 196
//     KB. One block per SM.
//   - The epilogue adds the bias and applies LeakyReLU in f32 to the sums;
//     lanes pair up by one shuffle so each makes 16-byte stores of 4
//     channels.
//   - Each output is one block's sum in a fixed K order, so two launches
//     give the same bits.
//   - Still not bound by the tensor cores (PERF.md): with one product in
//     place of three the 18 segmentation layers take only 12% less.
// Direct (Cin < 8, route "direct": the 2-channel stem): bound by bytes
// (it writes 16 Cout bytes per input channel read), and 4-channel planes
// would waste most of a k8 step. Each thread computes NB output channels
// of one pixel with exact f32 FMAs, its weights in shared memory
// (broadcast reads), its inputs from the L1-cached image.
// Why CUDA C++ and not Triton: Triton's tl.dot in TF32 gives no control of
// the operand split, nor of the halo layout that makes a tap's shift an
// address offset.

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kThreads = 256;  // two warpgroups
constexpr int kKStage = 32;    // K per weight stage: one 128-byte row
constexpr int kRing = 4, kAhead = kRing - 2;
// Stages whose MMAs share one tensor-core sum before it is added to the
// register sum (see the K loop).
constexpr int kPromote = 4;
constexpr int kSegW = 64;      // widest column segment
constexpr int kPosBytes = 64;  // 16 f32 channels of a halo position

// v rounded to the nearest tf32, ties away from zero, low 13 bits clear:
// cvt.rna.tf32.f32's rounding, done in two integer operations (the cvt
// issues at a quarter of their rate, and the split converts every operand
// value twice). Adding half a tf32 ulp to the bits rounds the magnitude.
__device__ __forceinline__ uint32_t tf32_bits(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// The two halves of a k8 step's A fragment: big and small parts of four
// values.
__device__ __forceinline__ void split4(float v0, float v1, float v2, float v3,
                                       uint32_t (&big)[4],
                                       uint32_t (&small)[4]) {
  const float v[4] = {v0, v1, v2, v3};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    big[i] = tf32_bits(v[i]);
    small[i] = tf32_bits(v[i] - __uint_as_float(big[i]));
  }
}

__device__ __forceinline__ float4 lds128(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}

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
// Keeps A fragments alive (unmoved) until the wgmmas that read them are
// known complete.
template <int MT>
__device__ __forceinline__ void hold_frags(uint32_t (&f)[MT][2][4]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(f[m][s][i])::"memory");
}

// D(64 x N, f32) += A(64 x 8, tf32, registers) * B(8 x N, tf32, shared), or
// D = A * B when scale_d is 0.
template <int N>
struct Tf32Mma;

template <>
struct Tf32Mma<16> {
  static __device__ __forceinline__ void mma(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t bdesc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(bdesc),
          "r"(scale_d));
  }
};

template <>
struct Tf32Mma<32> {
  static __device__ __forceinline__ void mma(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t bdesc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(bdesc),
          "r"(scale_d));
  }
};

template <>
struct Tf32Mma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t bdesc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(bdesc),
          "r"(scale_d));
  }
};

template <>
struct Tf32Mma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t bdesc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
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
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(bdesc),
          "r"(scale_d));
  }
};

struct F32Args {
  const float* x;     // (B, H, W, Cin)
  const float* bias;  // (Cout,)
  float* y;           // (B, H, W, Cout)
  int batch, h, w, cin, cout;
  int cc_log2;        // log2 of the channels per halo chunk (16 or 32)
  int chunks;         // halo chunks: padded Cin / chunk
  int ktot;           // taps x padded Cin
  int kp;             // ktot rounded up to kKStage
  int tw, hw, segs;   // segment width, its padded pitch, segments per row
  int tiles_seg;      // M tiles per (image, segment)
  int pad_mode, has_leak;
  int vec;            // 1: 16-byte halo copies (Cin % 4 == 0), 0: 4-byte
  float leak;
};

// Output tile `t`: image, column segment's first column, first position
// in the segment's flattened rows, first output channel. Channel blocks
// vary fastest, so blocks that run together share their halo in L2.
struct TileAt {
  int img, x0, q0, n0;
};

template <int N, int MT>
__device__ __forceinline__ TileAt tile_at(const F32Args& a, int t) {
  const int nblk = a.cout / N;
  TileAt r;
  r.n0 = (t % nblk) * N;
  t /= nblk;
  r.q0 = (t % a.tiles_seg) * (128 * MT);
  t /= a.tiles_seg;
  r.x0 = (t % a.segs) * a.tw;
  r.img = t / a.segs;
  return r;
}

// Halo positions of a tile and the bytes of one 16-channel plane.
__host__ __device__ __forceinline__ int halo_pos(int mt, int k, int hw) {
  return 128 * mt + (k - 1) * hw + (k - 1);
}
__host__ __device__ __forceinline__ int plane_bytes(int mt, int k, int hw) {
  return (halo_pos(mt, k, hw) * kPosBytes + 127) / 128 * 128;
}

template <int K, int N, int MT>
__global__ void __launch_bounds__(kThreads, 1)
conv_tf32x3_kernel(const F32Args a, int ntiles,
                   const __grid_constant__ CUtensorMap wmap) {
  constexpr int kPadT = (K - 1) / 2, NA = N / 2;
  constexpr int kSlot = 2 * N * 128;  // a ring slot: big, then small rows
  extern __shared__ unsigned char smem_raw[];
  // the swizzled weight stages want 1024-byte alignment
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t ring = base;
  const uint32_t halo0 = base + kRing * kSlot;
  const int cc = 1 << a.cc_log2;
  const int hw = a.hw;
  const int npos = halo_pos(MT, K, hw);
  const int plane = plane_bytes(MT, K, hw);
  const int halo_bytes = (cc >> 4) * plane;
  const uint32_t wbar = halo0 + 2 * halo_bytes;  // an mbarrier per slot
  const int span = K * K * cc;                   // K per halo chunk
  const int stages = a.kp / kKStage;             // per tile
  const int my_tiles = (ntiles - (int)blockIdx.x + (int)gridDim.x - 1) /
                       (int)gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wq = warp & 3;
  const int g4 = lane >> 2, t4 = lane & 3;

  // The next stage of this block's stream of weight stages into its ring
  // slot: the big rows of the tile's channels, then their small rows
  // (thread 0, which keeps the cursor: stage wg_ in the stream, stage ws_
  // of local tile wl_, its first channel wn_).
  int wg_ = 0, ws_ = 0, wl_ = 0, wn_ = 0;
  auto load_weights = [&]() {
    if (wl_ >= my_tiles) return;
    if (ws_ == 0) wn_ = tile_at<N, MT>(a, blockIdx.x + wl_ * gridDim.x).n0;
    const int slot = wg_ % kRing;
    const uint32_t dst = ring + slot * kSlot;
    mbar_expect(wbar + 8 * slot, kSlot);
    tma_load_2d(dst, &wmap, ws_ * kKStage, wn_, wbar + 8 * slot);
    tma_load_2d(dst + N * 128, &wmap, ws_ * kKStage, a.cout + wn_,
                wbar + 8 * slot);
    ++wg_;
    if (++ws_ == stages) {
      ws_ = 0;
      ++wl_;
    }
  };

  // Halo chunk c of local tile lt into halo buffer `buf`, by all threads:
  // position p of the tile is padded position q0 + p of its segment,
  // row (q0 + p) / HW, column (q0 + p) % HW.
  auto load_halo = [&](int lt, int c, int buf) {
    if (lt >= my_tiles) return;
    const TileAt tl = tile_at<N, MT>(a, blockIdx.x + lt * gridDim.x);
    const uint32_t hdst = halo0 + buf * halo_bytes;
    const float* xb = a.x + (size_t)tl.img * a.h * a.w * a.cin;
    const int gl2 = a.cc_log2 - 2;  // log2 of 4-channel groups per chunk
    for (int i = tid; i < npos << gl2; i += kThreads) {
      const int p = i >> gl2, v = i & ((1 << gl2) - 1);
      const int gq = tl.q0 + p;
      const int hy = gq / hw, hx = gq - hy * hw;
      const int sy = pad_index(hy - kPadT, a.h, a.pad_mode);
      const int sx = pad_index(tl.x0 + hx - kPadT, a.w, a.pad_mode);
      const bool in = sy >= 0 && sx >= 0;
      const int ch = (c << a.cc_log2) + 4 * v;
      const size_t src = ((size_t)sy * a.w + sx) * a.cin + ch;
      const uint32_t dst = hdst + (v >> 2) * plane + p * kPosBytes +
                           (v & 3) * 16;
      if (a.vec) {
        const bool ok = in && ch < a.cin;
        cp_async16(dst, ok ? xb + src : a.x, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = in && ch + e < a.cin;
          cp_async4(dst + 4 * e, ok ? xb + src + e : a.x, ok ? 4 : 0);
        }
      }
    }
    cp_async_commit();
  };

  // acc: the tensor cores' sum of one stage; sum: the tile's, in f32 on
  // the CUDA cores
  float acc[MT][NA], sum[MT][NA];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[mt][i] = sum[mt][i] = 0.f;
  // A fragments of the two k16 groups of a stage: [m tile][k8 step][reg]
  uint32_t big0[MT][2][4], small0[MT][2][4], big1[MT][2][4],
      small1[MT][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        big0[mt][s][i] = small0[mt][s][i] = big1[mt][s][i] =
            small1[mt][s][i] = 0u;

  if (tid == 0) {
    for (int i = 0; i < kRing; ++i) mbar_init(wbar + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  load_halo(0, 0, 0);
  if (tid == 0)
    for (int g = 0; g < kAhead; ++g) load_weights();

  // This thread's first position in the tile: m tile 0 of its warpgroup,
  // row g4 of its warp's 16.
  const int prow = wg * MT * 64 + wq * 16 + g4;

  // Loads and splits the A fragments of k16 group rq (K offset in the
  // chunk) from halo buffer hb.
  auto load_a = [&](uint32_t hb, int rq, uint32_t (&big)[MT][2][4],
                    uint32_t (&small)[MT][2][4]) {
    const int tap = rq >> a.cc_log2;
    const int j = (rq & (cc - 1)) >> 4;
    const int dy = tap / K, dx = tap - dy * K;
    const uint32_t at = hb + j * plane +
                        (prow + dy * hw + dx) * kPosBytes + t4 * 16;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const float4 lo = lds128(at + mt * 64 * kPosBytes);
      const float4 hi = lds128(at + (mt * 64 + 8) * kPosBytes);
      // column t4 + 4 h of k8 step s is channel 4 t4 + 2 s + h
      split4(lo.x, hi.x, lo.y, hi.y, big[mt][0], small[mt][0]);
      split4(lo.z, hi.z, lo.w, hi.w, big[mt][1], small[mt][1]);
    }
  };

  // The 6 MT wgmmas of one k16 group (k8 steps 2 q2, 2 q2 + 1 of the
  // stage): small x big, big x small, big x big. ``first`` is the scale
  // of the group's first: 0 overwrites what the accumulators held.
  auto mma_group = [&](int q2, int first, uint64_t dbig, uint64_t dsmall,
                       uint32_t (&big)[MT][2][4],
                       uint32_t (&small)[MT][2][4]) {
    wgmma_fence();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int st = 0; st < 2; ++st) {
        const int kq = 2 * q2 + st;  // k8 step in the stage: 32 bytes on
        Tf32Mma<N>::mma(acc[mt], small[mt][st], dbig + 2 * kq,
                        st == 0 ? first : 1);
        Tf32Mma<N>::mma(acc[mt], big[mt][st], dsmall + 2 * kq, 1);
        Tf32Mma<N>::mma(acc[mt], big[mt][st], dbig + 2 * kq, 1);
      }
    wgmma_commit();
    fence_acc<MT, NA>(acc);
  };

  // Cursors: the stage in the block's stream, the chunk in it (its halo
  // buffer is gc & 1), the K offset within the chunk, the chunk within
  // the tile.
  int gs = 0, gc = 0, rem = 0, c = 0;
#pragma unroll 1
  for (int lt = 0; lt < my_tiles; ++lt) {
#pragma unroll 1
    for (int sb = 0; sb < stages; sb += kPromote) {
      const int s_end = min(sb + kPromote, stages);
#pragma unroll 1
      for (int s = sb; s < s_end; ++s, ++gs) {
        if (rem == 0) cp_async_wait<0>();  // the chunk's halo
        mbar_wait(wbar + 8 * (gs % kRing), (gs / kRing) & 1);
        // every thread is past the A loads of the previous chunk and past
        // stage s - 2's MMAs: that slot takes stage s + kAhead, and at a
        // chunk's first stage the other halo buffer takes the next chunk
        __syncthreads();
        if (tid == 0) load_weights();
        const int kleft = (a.ktot - s * kKStage) >> 4;  // k16 groups left
        const uint32_t hb = halo0 + (gc & 1) * halo_bytes;
        const uint32_t slot = ring + (gs % kRing) * kSlot;
        const uint64_t dbig = b_desc(slot), dsmall = b_desc(slot + N * 128);
        // group 0 in fragment set 0, group 1 in set 1; each wait leaves one
        // group in flight, whose fragments are held until the next wait
        load_a(hb, rem, big0, small0);
        mma_group(0, s != sb, dbig, dsmall, big0, small0);
        wgmma_wait<1>();
        hold_frags<MT>(big1);
        hold_frags<MT>(small1);
        // the next chunk's halo, issued behind group 0's MMAs
        if (rem == 0) {
          if (c + 1 < a.chunks) load_halo(lt, c + 1, (gc + 1) & 1);
          else load_halo(lt + 1, 0, (gc + 1) & 1);
        }
        if (kleft > 1) {
          load_a(hb, rem + 16, big1, small1);
          mma_group(1, 1, dbig, dsmall, big1, small1);
          wgmma_wait<1>();
          hold_frags<MT>(big0);
          hold_frags<MT>(small0);
        }
        rem += kKStage;
        if (rem >= span) {
          rem = 0;
          ++c;
          ++gc;
        }
      }
      // The tensor cores truncate each f32 addition into the accumulator
      // (round toward zero), a bias that grows with the number of MMAs into
      // one sum: all K = 4608 in one sum read ~1e-4 off. So the MMAs of
      // kPromote stages (48) start from 0, and their sum is added here,
      // rounded to nearest, after the pipe drains.
      wgmma_wait<0>();
      fence_acc<MT, NA>(acc);
      hold_frags<MT>(big0);
      hold_frags<MT>(small0);
      hold_frags<MT>(big1);
      hold_frags<MT>(small1);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < NA; ++i) sum[mt][i] += acc[mt][i];
    }
    // Epilogue from the sums, laid out as the accumulators: value i of this
    // lane is row g4 (+8 if i & 2), channel 8 (i / 4) + 2 t4 + (i & 1).
    // Lanes t4 and t4 ^ 1 swap a pair, so each holds 4 consecutive
    // channels.
    const TileAt tl = tile_at<N, MT>(a, blockIdx.x + lt * gridDim.x);
    const bool odd = t4 & 1;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int q = tl.q0 + prow + mt * 64 + 8 * half;
        const int oy = q / hw, ox = q - oy * hw;
        const bool ok = oy < a.h && ox < a.tw && tl.x0 + ox < a.w;
        float* dst = a.y + (((size_t)tl.img * a.h + oy) * a.w + tl.x0 + ox) *
                               a.cout + tl.n0;
#pragma unroll
        for (int jp = 0; jp < N / 16; ++jp) {
          float2 v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = 2 * jp + e;
            const float2 bv = __ldg(reinterpret_cast<const float2*>(
                a.bias + tl.n0 + 8 * j + 2 * t4));
            float v0 = sum[mt][4 * j + 2 * half] + bv.x;
            float v1 = sum[mt][4 * j + 2 * half + 1] + bv.y;
            if (a.has_leak) {
              if (v0 < 0.f) v0 *= a.leak;
              if (v1 < 0.f) v1 *= a.leak;
            }
            v[e] = make_float2(v0, v1);
          }
          // even lanes keep pair 2 jp and take their partner's; odd lanes
          // keep pair 2 jp + 1 and take theirs
          const float2 send = odd ? v[0] : v[1];
          float2 got;
          got.x = __shfl_xor_sync(0xffffffffu, send.x, 1);
          got.y = __shfl_xor_sync(0xffffffffu, send.y, 1);
          const float4 out = odd ? make_float4(got.x, got.y, v[1].x, v[1].y)
                                 : make_float4(v[0].x, v[0].y, got.x, got.y);
          const int ch = odd ? 8 * (2 * jp + 1) + 2 * (t4 - 1)
                             : 8 * (2 * jp) + 2 * t4;
          if (ok) *reinterpret_cast<float4*>(dst + ch) = out;
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < NA; ++i) sum[mt][i] = 0.f;
    c = 0;  // the last stage moved gc on to the next tile's chunk 0
  }
  cp_async_wait<0>();
}

// --- the stem: Cin < 8, exact FMAs ------------------------------------

template <int K, int NB>
__global__ void __launch_bounds__(kThreads)
conv_direct_kernel(const float* __restrict__ x, const float* __restrict__ wt,
                   const float* __restrict__ bias, float* __restrict__ y,
                   int h, int w, int cin, int cout, int pad_mode,
                   int has_leak, float leak) {
  constexpr int kPadT = (K - 1) / 2;
  extern __shared__ float4 ws4[];  // (tap, channel, NB) of this channel block
  float* ws = reinterpret_cast<float*>(ws4);
  const int n0 = blockIdx.z * NB;
  for (int i = threadIdx.x; i < K * K * cin * NB; i += kThreads)
    ws[i] = wt[(size_t)(i / NB) * cout + n0 + i % NB];
  __syncthreads();
  const int pix = blockIdx.x * kThreads + threadIdx.x;
  if (pix >= h * w) return;
  const int oy = pix / w, ox = pix - oy * w;
  const float* xb = x + (size_t)blockIdx.y * h * w * cin;
  float acc[NB];
#pragma unroll
  for (int n = 0; n < NB; ++n) acc[n] = 0.f;
#pragma unroll 1
  for (int dy = 0; dy < K; ++dy) {
    const int sy = pad_index(oy + dy - kPadT, h, pad_mode);
#pragma unroll 1
    for (int dx = 0; dx < K; ++dx) {
      const int sx = pad_index(ox + dx - kPadT, w, pad_mode);
      const bool in = sy >= 0 && sx >= 0;
      const float* src = xb + ((size_t)(in ? sy : 0) * w + (in ? sx : 0)) *
                                  cin;
#pragma unroll 1
      for (int c = 0; c < cin; ++c) {
        const float v = in ? __ldg(src + c) : 0.f;
        const float4* wr = ws4 + ((dy * K + dx) * cin + c) * (NB / 4);
#pragma unroll
        for (int n = 0; n < NB / 4; ++n) {
          const float4 wv = wr[n];
          acc[4 * n] = fmaf(v, wv.x, acc[4 * n]);
          acc[4 * n + 1] = fmaf(v, wv.y, acc[4 * n + 1]);
          acc[4 * n + 2] = fmaf(v, wv.z, acc[4 * n + 2]);
          acc[4 * n + 3] = fmaf(v, wv.w, acc[4 * n + 3]);
        }
      }
    }
  }
  float* dst = y + ((size_t)blockIdx.y * h * w + pix) * cout + n0;
#pragma unroll
  for (int n = 0; n < NB; n += 4) {
    float4 out;
    float* o = reinterpret_cast<float*>(&out);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v = acc[n + e] + __ldg(bias + n0 + n + e);
      if (has_leak && v < 0.f) v *= leak;
      o[e] = v;
    }
    *reinterpret_cast<float4*>(dst + n) = out;
  }
}

template <int K>
int launch_direct(const void* x, const void* wt, const void* bias, void* y,
                  int batch, int h, int w, int cin, int cout, int pad_mode,
                  int has_leak, float leak, cudaStream_t st) {
  const int nb = cout % 32 == 0 ? 32 : 16;
  const int smem = K * K * cin * nb * 4;
  dim3 grid((unsigned)((h * w + kThreads - 1) / kThreads), batch, cout / nb);
  if (nb == 32)
    conv_direct_kernel<K, 32><<<grid, kThreads, smem, st>>>(
        (const float*)x, (const float*)wt, (const float*)bias, (float*)y, h,
        w, cin, cout, pad_mode, has_leak, leak);
  else
    conv_direct_kernel<K, 16><<<grid, kThreads, smem, st>>>(
        (const float*)x, (const float*)wt, (const float*)bias, (float*)y, h,
        w, cin, cout, pad_mode, has_leak, leak);
  return (int)cudaGetLastError();
}

// --- host side of the 3xTF32 route ------------------------------------

// Padded Cin and halo chunk (ops/conv_chain.py::gemm_layout_f32): one chunk
// of Cin rounded up to 16 for Cin <= 16, else chunks of 32 for k3 (9 x 32
// = 288 of K, 9 whole stages) and 16 for k4 (16 x 16 = 256, 8 stages).
void gemm_layout(int cin, int k, int* cc_log2, int* chunks, int* ktot,
                 int* kp) {
  const int cc = (cin <= 16 || k == 4) ? 16 : 32;
  const int pad = (cin + cc - 1) / cc * cc;
  *cc_log2 = cc == 16 ? 4 : 5;
  *chunks = pad / cc;
  *ktot = k * k * pad;
  *kp = (*ktot + kKStage - 1) / kKStage * kKStage;
}

int smem_bytes(int mt, int n, int k, const F32Args& a) {
  return 1024 + kRing * 2 * n * 128 +
         2 * ((1 << a.cc_log2) >> 4) * plane_bytes(mt, k, a.hw) + 8 * kRing;
}

// Blocks per SM of one instantiation at a layer's shared memory (0 if it
// does not fit), cached by kernel and bytes.
int blocks_per_sm(const void* kern, int smem) {
  static struct { const void* kern; int smem, n; } cache[64];
  static int used = 0;
  for (int i = 0; i < used; ++i)
    if (cache[i].kern == kern && cache[i].smem == smem) return cache[i].n;
  // the attribute is the kernel's ceiling, not this layer's bytes: one
  // value for every layer, so a cached answer stays true
  int dev = 0, most = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (smem > most ||
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           most) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, kThreads,
                                                    smem) != cudaSuccess)
    n = 0;
  if (used < 64) cache[used++] = {kern, smem, n};
  return n;
}

long tiles_of(const F32Args& a, int mt, int n) {
  return (long)a.batch * a.segs * ((a.h * a.hw + 128 * mt - 1) / (128 * mt)) *
         (a.cout / n);
}

template <int K, int N, int MT>
int per_sm(const F32Args& a) {
  return blocks_per_sm((const void*)conv_tf32x3_kernel<K, N, MT>,
                       smem_bytes(MT, N, K, a));
}

template <int K, int N, int MT>
int launch_gemm(F32Args a, const void* wp, int fit, cudaStream_t st) {
  // weights: (2 Cout, kp), big rows then small rows; a stage is a 32 x N
  // box of each, stored with the 128-byte swizzle b_desc names
  CUtensorMap wmap;
  if (!weight_map(&wmap, wp, a.kp * 4, 2 * a.cout, kKStage * 4, N,
                  CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4))
    return (int)cudaErrorInvalidValue;
  a.tiles_seg = (a.h * a.hw + 128 * MT - 1) / (128 * MT);
  const long ntiles = tiles_of(a, MT, N);
  if (ntiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)(ntiles < fit ? ntiles : fit);
  conv_tf32x3_kernel<K, N, MT><<<grid, kThreads, smem_bytes(MT, N, K, a),
                                 st>>>(a, (int)ntiles, wmap);
  return (int)cudaGetLastError();
}

// The (MT, N) of a layer: of the tiles that fit, the one with the least
// cost = waves x blocks per SM x MT x N x a per-tile overhead factor
// (smaller N and MT reuse the halo and A fragments less).
template <int K>
int launch_gemm_best(const F32Args& a, const void* wp, cudaStream_t st) {
  struct Cand {
    int mt, n, eff;
    int (*fits)(const F32Args&);
    int (*launch)(F32Args, const void*, int, cudaStream_t);
  };
  static const Cand cands[] = {
      {1, 128, 110, per_sm<K, 128, 1>, launch_gemm<K, 128, 1>},
      {2, 64, 115, per_sm<K, 64, 2>, launch_gemm<K, 64, 2>},
      {1, 64, 126, per_sm<K, 64, 1>, launch_gemm<K, 64, 1>},
      {2, 32, 150, per_sm<K, 32, 2>, launch_gemm<K, 32, 2>},
      {1, 32, 165, per_sm<K, 32, 1>, launch_gemm<K, 32, 1>},
      {2, 16, 220, per_sm<K, 16, 2>, launch_gemm<K, 16, 2>},
      {1, 16, 242, per_sm<K, 16, 1>, launch_gemm<K, 16, 1>},
  };
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int best = -1, best_fit = 0;
  long long best_cost = 0;
  for (int i = 0; i < (int)(sizeof(cands) / sizeof(cands[0])); ++i) {
    const Cand& c = cands[i];
    if (a.cout % c.n) continue;
    const int ps = c.fits(a);
    if (ps < 1) continue;
    const long fit = (long)ps * sms;
    const long waves = (tiles_of(a, c.mt, c.n) + fit - 1) / fit;
    const long long cost = (long long)waves * ps * c.mt * c.n * c.eff;
    if (best < 0 || cost < best_cost) {
      best = i;
      best_cost = cost;
      best_fit = (int)fit;
    }
  }
  if (best < 0) return (int)cudaErrorInvalidConfiguration;
  return cands[best].launch(a, wp, best_fit, st);
}

}  // namespace

// x: (batch, h, w, cin), y: (batch, h, w, cout), contiguous f32, x and y
// 16-byte aligned; cout a multiple of 16 (the wrapper pads other Couts
// with zero output channels); bias: (cout,) f32. Cin >= 8: wt is the
// (2 cout, kp) operand of ops/conv_chain.py::pack_weights_f32, kp its row
// length (checked). Cin < 8: wt is the HWIO weight (k, k, cin, cout) and kp
// is 0. pad_mode: 0 zero, 1 reflect, 2 replicate. Launches on `stream`;
// returns cudaGetLastError() after it.
extern "C" int conv_layer_f32(const void* x, const void* wt, int kp,
                              const void* bias, void* y, int batch, int h,
                              int w, int cin, int cout, int k, int pad_mode,
                              int has_leak, float leak, void* stream) {
  if (batch < 1 || batch > 65535 || h < 1 || w < 1 || cin < 1 || cout < 16 ||
      cout % 16 || cout / 16 > 65535 || pad_mode < 0 || pad_mode > 2 ||
      (k != 3 && k != 4) || (uintptr_t)x % 16 || (uintptr_t)wt % 16 ||
      (uintptr_t)y % 16 || (pad_mode == kReflect && (h < 2 || w < 2)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (cin < 8) {
    if (kp != 0) return (int)cudaErrorInvalidValue;
    if (k == 3)
      return launch_direct<3>(x, wt, bias, y, batch, h, w, cin, cout,
                              pad_mode, has_leak, leak, st);
    return launch_direct<4>(x, wt, bias, y, batch, h, w, cin, cout, pad_mode,
                            has_leak, leak, st);
  }
  F32Args a;
  a.x = (const float*)x;
  a.bias = (const float*)bias;
  a.y = (float*)y;
  a.batch = batch;
  a.h = h;
  a.w = w;
  a.cin = cin;
  a.cout = cout;
  int want_kp = 0;
  gemm_layout(cin, k, &a.cc_log2, &a.chunks, &a.ktot, &want_kp);
  if (kp != want_kp) return (int)cudaErrorInvalidValue;
  a.kp = kp;
  a.tw = w < kSegW ? w : kSegW;
  a.hw = a.tw + k - 1;
  a.segs = (w + a.tw - 1) / a.tw;
  a.tiles_seg = 0;
  a.pad_mode = pad_mode;
  a.has_leak = has_leak;
  a.vec = cin % 4 == 0;
  a.leak = leak;
  if (k == 3) return launch_gemm_best<3>(a, wt, st);
  return launch_gemm_best<4>(a, wt, st);
}
