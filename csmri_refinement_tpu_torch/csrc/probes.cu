// Primitive probes for Hopper (sm_90a): small kernels that check, each
// against a plain PyTorch version, the primitives the port's conv kernels
// are built from, with the Hopper instructions those kernels use or will.
//
// Replace the TPU probes csmri_refinement_tpu/scripts/probe_mosaic_prims.py
// (K4: which Mosaic layout primitives a bf16 Pallas kernel may use) and
// scripts/probe_int8_prims.py (K5: the int8 primitives of the quantized
// chain kernel). The TPU asked whether its compiler accepts a lane roll, an
// unaligned slice or an s8 dot; here the same questions are asked of what
// csrc/conv_chain.cu (K2) and csrc/conv_int8.cu (K3) do:
//   K4 (bf16_move_probe, odd_pixel_probe): bf16 rows staged in shared
//     memory and moved as single values or 32-bit pairs, rows read and
//     written at unaligned offsets, and K2's halo read: a wgmma bf16 A
//     operand through a no-swizzle K-major descriptor whose start is an odd
//     pixel of a planar halo;
//   K5 (s8_mma_probe, int8_move_probe, requant_probe): the s8 x s8 -> s32
//     product on wgmma (m64n64k32) from K-major shared-memory operands, with
//     the f32 dequant from the accumulators; an int8 lane roll and select
//     moved as 16-byte vectors; the whole-tile requant as one cluster of 8
//     blocks that exchange their maxima through distributed shared memory.
//
// What bounds them: bytes, a 256 x 128 tile in and out (64 KB of bf16; the
// s8 product's 8.4 M operations take 4 ns at 1979 TOP/s), so a probe's
// floor is a launch. Each runs as one wave of 4-32 blocks, one or two
// 16-byte accesses a thread, so that its device time is near a launch's.
//
// Layout checks: the wgmma descriptors' layout fields (LBO, SBO, swizzle;
// the address left 0) are decided on the host (probes/int8_prims.py::
// mma_descriptors, probes/mosaic_prims.py::odd_pixel_descriptors) and must
// equal the constants compiled here, or the launch returns
// cudaErrorInvalidValue; tests/test_torch_port_kernel_layouts.py replays
// them on the CPU.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int L = 128;  // lanes (columns) of every probe tile

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// Thread stores are generic-proxy writes; wgmma reads its operands through
// the async proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Layout fields of a wgmma shared-memory descriptor: LBO and SBO in bytes
// (stored >> 4), swizzle mode (0 none, 1 = 128 bytes); the start address
// (bits 0-13, >> 4) is added per use.
constexpr uint64_t desc_fields(uint32_t lbo, uint32_t sbo, uint32_t mode) {
  return (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | (uint64_t)mode << 62;
}
__device__ __forceinline__ uint64_t desc_at(uint64_t fields, uint32_t addr) {
  return fields | ((addr >> 4) & 0x3FFF);
}

// ---- K4: bf16 layout moves --------------------------------------------

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
  kOddPixel = 9,      // x as (rows*L/16) pixels x 16: y (f32) = pixels
                      // [1 : rows*L/16 - 15] through wgmma A descriptors
                      // at odd pixels times the identity
};

constexpr int kBand = 16;           // output rows per block
constexpr int kRowVecs = L * 2 / 16;  // 16-byte vectors per bf16 row
constexpr int kMoveThreads = kBand * kRowVecs;  // one output vector each
constexpr int kHalo = 8;            // extra rows a band may stage

// 2x of a bf16 value given as its bits (exact).
__device__ __forceinline__ uint32_t twice(uint32_t bits) {
  return __bfloat16_as_ushort(__float2bfloat16(
      2.f * __bfloat162float(__ushort_as_bfloat16((unsigned short)bits))));
}

// Output rows of a move probe on a tile of `rows` rows.
__host__ __device__ __forceinline__ int move_out_rows(int op, int rows) {
  return op == kRowRead ? rows - 16 : op == kMidDim ? rows / 8 : rows;
}

// One band of 16 output rows a block: the rows the band reads are staged
// into shared memory with one 16-byte load a thread (the band itself, or
// shifted by a row, with the wrap or zeros at the tile's edge, or with the
// scratch chain's 8-row halo); then each thread builds one 16-byte output
// vector from shared memory and stores it. One instance per move, so that
// each kernel is only its own move.
template <int op>
__global__ void __launch_bounds__(kMoveThreads)
bf16_move_probe(const __nv_bfloat16* __restrict__ x,
                __nv_bfloat16* __restrict__ y, int rows) {
  __shared__ uint4 sv[(kBand + kHalo) * kRowVecs];
  const unsigned short* s = reinterpret_cast<const unsigned short*>(sv);
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * kBand;
  const int out_rows = move_out_rows(op, rows);
  // shared row i holds source row first + i (the mid-dim probe: 8 (r0 + i)
  // + 3); rows outside the tile are zeros (the row roll wraps)
  const int first = op == kRowRoll || op == kRowWrite ? r0 - 1
                    : op == kRowRead                  ? r0 + 1
                    : op == kScratch                  ? r0 - kHalo
                                                      : r0;
  const int staged = op == kScratch ? kBand + kHalo : kBand;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  for (int v = tid; v < staged * kRowVecs; v += kMoveThreads) {
    const int i = v / kRowVecs, c = v % kRowVecs;
    int src = op == kMidDim ? 8 * (r0 + i) + 3 : first + i;
    if (op == kRowRoll) src = (src + rows) % rows;
    const bool in = src >= 0 && src < (op == kRowWrite ? rows - 16 : rows);
    sv[v] = in ? __ldg(xv + (size_t)src * kRowVecs + c)
               : make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  if (op == kScratch && r0 == 0) {  // s[0:8] = s[8:16], in shared memory
    if (tid < kHalo * kRowVecs) sv[tid] = sv[tid + kHalo * kRowVecs];
    __syncthreads();
  }

  const int i = tid / kRowVecs, c = tid % kRowVecs;
  if (r0 + i >= out_rows) return;
  uint32_t w[4];
  switch (op) {
    case kLaneRoll:
    case kIotaSelect:
    case kScratch: {  // value by value
      const unsigned short* row = s + (op == kScratch ? i + 1 : i) * L;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int lane = 8 * c + e;
        uint32_t v;
        if (op == kLaneRoll)
          v = row[(lane + L - 32) % L];
        else if (op == kScratch || lane < 32)
          v = twice(row[lane]);
        else
          v = row[lane];
        w[e >> 1] = e & 1 ? w[e >> 1] | v << 16 : v;
      }
      break;
    }
    case kLaneRollPair:
    case kPairRoll64: {  // 32-bit pairs
      constexpr int W = L / 2;  // words per row
      const int shift = op == kLaneRollPair ? 16 : 32;
      const uint32_t* row = reinterpret_cast<const uint32_t*>(sv) + i * W;
#pragma unroll
      for (int e = 0; e < 4; ++e) w[e] = row[(4 * c + e + W - shift) % W];
      break;
    }
    default: {  // row moves: the staging moved the rows
      const uint4 v = sv[tid];
      w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
    }
  }
  reinterpret_cast<uint4*>(y)[(size_t)(r0 + i) * kRowVecs + c] =
      make_uint4(w[0], w[1], w[2], w[3]);
}

// The odd-pixel probe: K2's halo read (csrc/sm90.cuh::a_desc and its use
// at every tap in csrc/conv_chain.cu). A block stages the pixels of its tiles, plus one, as
// two planes (channels 0-7 and 8-15) of 16-byte pixel rows, as K2 stores
// its halo, and reads each 64-pixel tile through a no-swizzle K-major A
// descriptor whose start is the tile's first pixel, 1 + 64 t: 8-pixel core
// matrices 128 bytes apart (SBO), the second 8 channels one plane on
// (LBO). B is the 16 x 16 identity, K-major: D = A exactly, in f32.
constexpr int kOddTiles = 1;                  // 64-pixel tiles per block
constexpr int kOddPix = 64 * kOddTiles + 8;   // staged pixels a block
constexpr int kOddPlane = kOddPix * 16;       // bytes per channel plane
constexpr uint64_t kOddADesc = desc_fields(kOddPlane, 128, 0);
// identity B: n-rows of 16 bytes (8 k), the second 8 of k 256 bytes on
constexpr uint64_t kOddBDesc = desc_fields(256, 128, 0);

__global__ void __launch_bounds__(128)
odd_pixel_probe(const __nv_bfloat16* __restrict__ x, float* __restrict__ y,
                int pixels) {
  __shared__ __align__(128) unsigned char s[2 * kOddPlane + 512];
  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * 64 * kOddTiles;  // first staged pixel
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  for (int i = tid; i < 2 * kOddPix; i += 128) {
    const int p = i >> 1, g = i & 1;
    const bool in = p0 + p < pixels;
    *reinterpret_cast<uint4*>(s + g * kOddPlane + p * 16) =
        in ? __ldg(xv + 2 * (size_t)(p0 + p) + g) : make_uint4(0u, 0u, 0u, 0u);
  }
  __nv_bfloat16* eye = reinterpret_cast<__nv_bfloat16*>(s + 2 * kOddPlane);
  for (int e = tid; e < 256; e += 128) {  // entry (k, n) of the identity
    const int n = e >> 4, k = e & 15;
    eye[(k >> 3) * 128 + n * 8 + (k & 7)] = __float2bfloat16(k == n ? 1.f
                                                                    : 0.f);
  }
  fence_proxy_async();
  __syncthreads();

  const uint32_t base = smem_u32(s);
  const uint64_t bd = desc_at(kOddBDesc, base + 2 * kOddPlane);
  float acc[kOddTiles][8];
#pragma unroll
  for (int t = 0; t < kOddTiles; ++t)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[t][i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int t = 0; t < kOddTiles; ++t) {
    const uint64_t ad = desc_at(kOddADesc, base + (1 + 64 * t) * 16);
    asm volatile(  // D = A B (scale-d false), no transpose
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(acc[t][0]), "+f"(acc[t][1]), "+f"(acc[t][2]), "+f"(acc[t][3]),
          "+f"(acc[t][4]), "+f"(acc[t][5]), "+f"(acc[t][6]), "+f"(acc[t][7])
        : "l"(ad), "l"(bd), "r"(0));
  }
  wgmma_commit();
  wgmma_wait_all();

  // accumulator i of this lane: row 16 warp + lane/4 (+8 if i & 2),
  // column 8 (i / 4) + 2 (lane % 4) + (i & 1); output row o is pixel o + 1
  const int warp = tid >> 5, lane = tid & 31;
  const int out_pixels = pixels - 16;
#pragma unroll
  for (int t = 0; t < kOddTiles; ++t)
#pragma unroll
    for (int i = 0; i < 8; i += 2) {
      const int o = p0 + 64 * t + 16 * warp + (lane >> 2) + 8 * ((i >> 1) & 1);
      const int col = 8 * (i >> 2) + 2 * (lane & 3);
      if (o < out_pixels)
        *reinterpret_cast<float2*>(y + (size_t)o * 16 + col) =
            make_float2(acc[t][i], acc[t][i + 1]);
    }
}

// ---- K5: int8 primitives -------------------------------------------------

enum Int8Op {
  kMma = 0,         // y (s32) = a (R x 128 s8) . b (128 x 128 s8)
  kWordRoll = 1,    // y = roll(a, 32, axis=1), moved as 32-bit words
  kSelect = 2,      // y = where(col < 32, a, 0)
  kRequant = 3,     // y = clip(rint(f * 127 / max(max|f|, 1e-8)), +-127)
  kMmaDequant = 4,  // y (f32) = (a . b) * 0.01
};

// The s8 product: a block per 64 rows x 64 columns of y, one warpgroup.
// Both operands K-major in shared memory (PTX allows no transpose for
// 8-bit types), 128 bytes of K a row, 128-byte swizzle: 16-byte chunk c of
// row r at r * 128 + 16 (c ^ r % 8), 8-row groups 1024 bytes apart (SBO);
// the LBO is unused (one row spans all of K). A k32 step is 32 bytes on.
constexpr int kMmaN = 64;
constexpr uint64_t kSw128Desc = desc_fields(16, 1024, 1);

__device__ __forceinline__ uint32_t sw128(int row, int byte) {
  return row * 128 + (byte ^ ((row & 7) << 4));
}

__device__ __forceinline__ uint32_t word_of(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

__device__ __forceinline__ void wgmma_s8(int (&d)[32], uint64_t ad,
                                         uint64_t bd, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(ad), "l"(bd), "r"(accumulate));
}

__global__ void __launch_bounds__(128)
s8_mma_probe(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
             void* __restrict__ out, int dequant) {
  __shared__ __align__(1024) unsigned char smem[2 * 64 * 128 + 1024];
  const uint32_t raw = smem_u32(smem);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle's alignment
  unsigned char* sa = smem + (base - raw);
  unsigned char* sb = sa + 64 * 128;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * 64, n0 = blockIdx.y * kMmaN;

  // A: rows m0.. of a are K-major already; 16-byte chunks into the swizzle
  const uint4* av = reinterpret_cast<const uint4*>(a + (size_t)m0 * L);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int i = tid + 128 * j, r = i >> 3, c = i & 7;
    *reinterpret_cast<uint4*>(sa + sw128(r, 16 * c)) = __ldg(av + i);
  }
  // B: b is (K, N), N-major. A thread loads rows 4 k4 .. + 3, columns
  // n0 + 16 nq .. + 15 (four 16-byte loads), transposes each 4 x 4 block of
  // bytes with byte permutes, and stores column n's four k bytes as one
  // word of K-major row n.
  {
    const int k4 = tid >> 2, nq = tid & 3;
    uint4 x[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      x[r] = __ldg(reinterpret_cast<const uint4*>(
          b + (size_t)(4 * k4 + r) * L + n0 + 16 * nq));
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t x0 = word_of(x[0], j), x1 = word_of(x[1], j);
      const uint32_t x2 = word_of(x[2], j), x3 = word_of(x[3], j);
      const uint32_t t0 = __byte_perm(x0, x1, 0x5140);  // x0.0 x1.0 x0.1 x1.1
      const uint32_t t1 = __byte_perm(x0, x1, 0x7362);  // x0.2 x1.2 x0.3 x1.3
      const uint32_t t2 = __byte_perm(x2, x3, 0x5140);
      const uint32_t t3 = __byte_perm(x2, x3, 0x7362);
      const uint32_t col[4] = {
          __byte_perm(t0, t2, 0x5410), __byte_perm(t0, t2, 0x7632),
          __byte_perm(t1, t3, 0x5410), __byte_perm(t1, t3, 0x7632)};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        *reinterpret_cast<uint32_t*>(sb + sw128(16 * nq + 4 * j + e,
                                                4 * k4)) = col[e];
    }
  }
  fence_proxy_async();
  __syncthreads();

  int d[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0;
  wgmma_fence();
#pragma unroll
  for (int q = 0; q < L / 32; ++q)
    wgmma_s8(d, desc_at(kSw128Desc, base + 32 * q),
             desc_at(kSw128Desc, base + 64 * 128 + 32 * q), q);
  wgmma_commit();
  wgmma_wait_all();

  // Epilogue from the accumulators: d[4j + 2h + e] is row 16 warp + lane/4
  // + 8h, column 8j + 2 (lane % 4) + e; 8-byte stores.
  const int warp = tid >> 5, lane = tid & 31;
#pragma unroll
  for (int j = 0; j < kMmaN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t idx = (size_t)(m0 + 16 * warp + (lane >> 2) + 8 * h) * L +
                         n0 + 8 * j + 2 * (lane & 3);
      const int v0 = d[4 * j + 2 * h], v1 = d[4 * j + 2 * h + 1];
      if (dequant)
        *reinterpret_cast<float2*>(reinterpret_cast<float*>(out) + idx) =
            make_float2(__fmul_rn(__int2float_rn(v0), 0.01f),
                        __fmul_rn(__int2float_rn(v1), 0.01f));
      else
        *reinterpret_cast<int2*>(reinterpret_cast<int*>(out) + idx) =
            make_int2(v0, v1);
    }
}

// Word roll and select: 32 rows a block, a 16-byte vector (4 words) a
// thread; a roll by 32 int8 lanes moves whole vectors (2 of a row's 8).
constexpr int kI8Vecs = L / 16;
constexpr int kI8Rows = 32;

__global__ void __launch_bounds__(kI8Rows * kI8Vecs)
int8_move_probe(int op, const int8_t* __restrict__ a,
                int8_t* __restrict__ y) {
  const int r = blockIdx.x * kI8Rows + threadIdx.x / kI8Vecs;
  const int c = threadIdx.x % kI8Vecs;
  const uint4* av = reinterpret_cast<const uint4*>(a) + (size_t)r * kI8Vecs;
  uint4* yv = reinterpret_cast<uint4*>(y) + (size_t)r * kI8Vecs;
  if (op == kWordRoll)
    yv[(c + 2) % kI8Vecs] = __ldg(av + c);
  else
    yv[c] = c < 2 ? __ldg(av + c) : make_uint4(0u, 0u, 0u, 0u);
}

// The requant: one cluster of 8 blocks, 32 rows (16 KB of f32) each, 16
// values a thread kept in registers. Each block reduces max |f| of its
// band; the blocks read each other's maxima through distributed shared
// memory; each quantizes its band with the one scale, 127 / max(amax,
// 1e-8) as one IEEE division, rint (half to even) and a clip to +-127.
constexpr int kClusterBlocks = 8;
constexpr int kRequantThreads = 256;
constexpr int kRequantRows = kRequantThreads * 16 / L;  // per block: 32

__global__ void __cluster_dims__(kClusterBlocks, 1, 1)
__launch_bounds__(kRequantThreads)
requant_probe(const float* __restrict__ f, int8_t* __restrict__ y) {
  __shared__ float warp_max[kRequantThreads / 32];
  __shared__ float block_max;
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t off = (size_t)blockIdx.x * kRequantRows * L + 16 * tid;
  float4 v[4];
  float m = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[j] = __ldg(reinterpret_cast<const float4*>(f + off) + j);
    m = fmaxf(m, fmaxf(fmaxf(fabsf(v[j].x), fabsf(v[j].y)),
                       fmaxf(fabsf(v[j].z), fabsf(v[j].w))));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (tid == 0) {
    float bm = 0.f;
#pragma unroll
    for (int w = 0; w < kRequantThreads / 32; ++w) bm = fmaxf(bm, warp_max[w]);
    block_max = bm;
  }
  cluster.sync();  // every block's maximum is written
  m = 0.f;
#pragma unroll
  for (int rank = 0; rank < kClusterBlocks; ++rank)
    m = fmaxf(m, *cluster.map_shared_rank(&block_max, rank));
  cluster.sync();  // no block leaves while another reads its maximum
  const float sc = __fdiv_rn(127.f, fmaxf(m, 1e-8f));
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float fv[4] = {v[j].x, v[j].y, v[j].z, v[j].w};
    uint32_t word = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float q = fminf(fmaxf(rintf(__fmul_rn(fv[e], sc)), -127.f), 127.f);
      word |= (uint32_t)(uint8_t)(int8_t)q << (8 * e);
    }
    w[j] = word;
  }
  *reinterpret_cast<uint4*>(y + off) = make_uint4(w[0], w[1], w[2], w[3]);
}

}  // namespace

// One K4 probe on a contiguous bf16 (rows, 128) tile x (the mid-dim probe
// reads it as (rows/8, 8, 128)); out is sized for the probe's result.
// a_desc, b_desc: the odd-pixel probe's descriptor layout fields
// (probes/mosaic_prims.py::odd_pixel_descriptors), checked for that probe.
// Returns cudaGetLastError() after the launch.
extern "C" int probe_bf16(int op, const void* x, void* out, int rows,
                          unsigned long long a_desc,
                          unsigned long long b_desc, void* stream) {
  if (op < kLaneRoll || op > kOddPixel || rows < 32 || rows > 4096 ||
      (op == kMidDim && rows % 8) || (uintptr_t)x % 16 ||
      (uintptr_t)out % 16 ||
      (op == kOddPixel && (a_desc != kOddADesc || b_desc != kOddBDesc))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  if (op == kOddPixel) {
    const int pixels = rows * L / 16;
    const int tiles = (pixels - 16 + 63) / 64;
    odd_pixel_probe<<<(tiles + kOddTiles - 1) / kOddTiles, 128, 0, st>>>(
        (const __nv_bfloat16*)x, (float*)out, pixels);
  } else {
    const int blocks = (move_out_rows(op, rows) + kBand - 1) / kBand;
    static void (*const kernels[])(const __nv_bfloat16*, __nv_bfloat16*,
                                   int) = {
        bf16_move_probe<kLaneRoll>, bf16_move_probe<kLaneRollPair>,
        bf16_move_probe<kRowRoll>, bf16_move_probe<kRowRead>,
        bf16_move_probe<kRowWrite>, bf16_move_probe<kIotaSelect>,
        bf16_move_probe<kMidDim>, bf16_move_probe<kScratch>,
        bf16_move_probe<kPairRoll64>};
    kernels[op]<<<blocks, kMoveThreads, 0, st>>>(
        (const __nv_bfloat16*)x, (__nv_bfloat16*)out, rows);
  }
  return (int)cudaGetLastError();
}

// One K5 probe: a is int8 (rows, 128) (f32 for the requant probe), b int8
// (128, 128) for the MMA probes (else unused). rows: a multiple of 64 for
// the MMA probes, of 32 for the roll and select, 256 for the requant (one
// cluster). a_desc, b_desc: the product's descriptor layout fields
// (probes/int8_prims.py::mma_descriptors), checked for the MMA probes.
extern "C" int probe_int8(int op, const void* a, const void* b, void* out,
                          int rows, unsigned long long a_desc,
                          unsigned long long b_desc, void* stream) {
  const bool mma = op == kMma || op == kMmaDequant;
  if (op < kMma || op > kMmaDequant || rows < 32 || rows > 65535 * 32 ||
      (uintptr_t)a % 16 || (uintptr_t)out % 16 ||
      (mma && (b == nullptr || (uintptr_t)b % 16 || rows % 64 ||
               a_desc != kSw128Desc || b_desc != kSw128Desc)) ||
      (op == kRequant && rows != kClusterBlocks * kRequantRows) ||
      rows % kI8Rows) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  if (mma) {
    s8_mma_probe<<<dim3(rows / 64, L / kMmaN), 128, 0, st>>>(
        (const int8_t*)a, (const int8_t*)b, out, op == kMmaDequant);
  } else if (op == kRequant) {
    requant_probe<<<kClusterBlocks, kRequantThreads, 0, st>>>(
        (const float*)a, (int8_t*)out);
  } else {
    int8_move_probe<<<rows / kI8Rows, kI8Rows * kI8Vecs, 0, st>>>(
        op, (const int8_t*)a, (int8_t*)out);
  }
  return (int)cudaGetLastError();
}
