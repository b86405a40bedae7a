// Fused k-space data consistency for Hopper (sm_90a).
//
// Replaces the TPU kernel csmri_refinement_tpu/ops/dc_pallas.py::_dc_kernel
// (wrapper dc_pallas, reached by ops/dc.py::_dc_fused):
//
//     y = F^-1((1 - m) * F x + k0)        F = ortho, unshifted 2D DFT
//
// on packed (B, H, W, 2) float32 images (interleaved re/im, read here as
// float2), a (B, H, W) float32 mask and (B, H, W, 2) float32 k0.
//
// The same entry is the DC's backward (K1-bwd, ops/dc.py::_dc_fused_bwd in
// the JAX package): the x-Jacobian F^-1 (1 - m) F is Hermitian, so
// grad_x = DC(g, 0, m). A null k0 means zero: the backward neither
// allocates nor reads a zero plane.
//
// What bounds it on the H100: bytes. Each pixel needs x, k0, mask and y
// once: 28 B/pixel (20 without k0), against ~10 log2(HW) f32 flops/pixel
// (~160 at 256^2: far under the card's f32 rate per byte of HBM traffic).
//
// Design. Three launches, each a pass at memory speed:
//   1. forward FFT along W: x -> scratch;
//   2. per strip of adjacent columns of one image, forward FFT along H,
//      the merge (1 - m) k + k0, inverse FFT along H, in place in scratch:
//      k-space makes no HBM round trip;
//   3. inverse FFT along W: scratch -> y.
// That moves 60 B/pixel against the 28 B bound; one launch per DC with
// thread-block clusters is later work. Each pass is an entry of its own
// too (dc_rows_pass, dc_cols_pass, at the end): a DC whose image rows are
// split over ranks runs them with an all-to-all between passes 1 and 2
// and another between 2 and 3, and dc_forward is the same three launches.
//
// Every side from 2 up, square or not, with one route per axis: passes 1
// and 3 take W's, pass 2 H's (ops/dc_kernel.py::dc_route):
//   * radix: powers of two from 2 to 1024. A thread holds P = 8 or 16
//     points of a line and does whole radix-8 or radix-16 DFTs on them (a
//     radix-2 network, constant twiddles), so a 256-point line is 16 x 16
//     with one exchange through shared memory between the two stages. The
//     plan (radices per n, below) is compiled per side, chosen on the host
//     (ops/dc_kernel.py::FFT_PLANS) and checked here. Row tiles are padded
//     by 16 bytes per 16 points against bank conflicts; column strips
//     (16 columns, 8 above 512 rows) need none (lines are the fastest
//     index). The merge operands (mask,
//     k0) of the points a thread will hold are loaded before its forward
//     transform starts.
//   * mixed radix: every other side to 1024 whose prime factors are at
//     most 13 (240 = 16 x 15, 320 = 8 x 8 x 5, 384 = 16 x 8 x 3, ...), and
//     a power of two H beside a W that is not one (ops/dc_kernel.py::
//     dc_route), so that a spatial rank's column block is never one that
//     the radix column pass cannot walk. The plan is a
//     runtime argument over one stage function per radix (2, 4, 8, 16 as
//     above; 3, 5, 7, 9, 11, 13, 15 as odd DFTs with constant roots); see
//     "mixed-radix lines" below.
//   * split: longer sides whose prime factors are at most 13 (1280, 2048,
//     4096, 16384, ...) and
//   * chirp: the sides with a prime factor above 13 past 80 (89, 127,
//     244, 368, 509, 1021, 1031, ...): Bluestein's chirp, a cyclic
//     convolution of a length m >= 2n - 1 whose prime factors are at most
//     13 (512 for 244, 792 for 368, 2112 for 1031, 4160 for 2053: the
//     host's cheapest plan, ops/dc_kernel.py::chirp_length); on both, one
//     launch a pass of block_lines where a tile of lines fits a block (a
//     chirp's m up to kBlockLine = 4628, a split line up to 3506), of
//     cluster_lines where a line fits a thread-block cluster of up to 8
//     blocks (4099: m = 8320 on 2 blocks; 16384 on 8) and the image has
//     enough lines of the axis, device stages (stage_lines) otherwise; see
//     "the chirp and split routes in one launch a pass" and "device
//     stages" below.
//   * dense: the sides with a prime factor above 13 up to 80
//     (ops/dc_kernel.py::DENSE_MAX: 17, 31, 61, 79, where n^2 operations
//     a line beat the chirp's four FFTs of m >= 2n): each output point a
//     sum over its whole line against a table of its n roots
//     exp(-2 pi i m / n), indexed by (j k) mod n, as the TPU kernel
//     computes every side (its DFT matrices, dc_pallas.py:77).
// On the FFT routes the inter-stage twiddles exp(-2 pi i m q / (Ns r)) come
// from the host, computed in f64 and rounded once to f32, and sit in
// shared memory. f32 FMA throughout (TF32 would lose ~2e-2 in k-space).
// Staging: every block walks several tiles (rows, or column strips) and
// copies the next tile into shared memory with cp.async while it
// transforms the current one. Above 512 points the tiles are narrower
// (col_strip, mix_row_lg, mix_col_lg), so that every block fits the
// H100's 227 KB of shared memory; the tiles up to 512 are as they were.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRowThreads = 128;  // 256 measured 5% slower at B = 32, 256^2
// The longest line of the radix, mixed-radix and dense routes' tiles
// (ops/dc_kernel.py::TILE_LINE), of a block's line (or share of a
// cluster's) on the chirp and split routes (BLOCK_LINE), and of a device
// stage's radix (STAGE_LINE).
constexpr int kTileLine = 1024;
constexpr int kBlockLine = 4628;
constexpr int kStageLine = 4096;

// Columns per strip in the radix and dense column passes
// (ops/dc_kernel.py::radix_strip): 16, and 8 above 512 rows, where a
// strip's two 16-column buffers of 1024 rows (256 KB) would not fit.
__host__ __device__ constexpr int col_strip(int h) {
  return h > 512 ? 8 : 16;
}

// --- the plan: radices per stage for each n (ops/dc_kernel.py::FFT_PLANS) ---

__host__ __device__ constexpr int plan_stages(int n) {
  return n <= 16 ? 1 : n >= 512 ? 3 : 2;
}
__host__ __device__ constexpr int plan_radix(int n, int s) {
  return n <= 16     ? (s == 0 ? n : 1)
         : n == 32   ? (s == 0 ? 8 : s == 1 ? 4 : 1)
         : n == 64   ? (s < 2 ? 8 : 1)
         : n == 128  ? (s == 0 ? 16 : s == 1 ? 8 : 1)
         : n == 256  ? (s < 2 ? 16 : 1)
         : n == 512  ? (s < 3 ? 8 : 1)
         : n == 1024 ? (s == 0 ? 16 : s < 3 ? 8 : 1)
                     : 0;
}
// points per thread: the largest radix
__host__ __device__ constexpr int plan_points(int n) {
  return n <= 16 ? n : (n == 128 || n == 256 || n == 1024) ? 16 : 8;
}
// Ns: the product of the radices before stage s
__host__ __device__ constexpr int plan_span(int n, int s) {
  return s == 0 ? 1 : plan_span(n, s - 1) * plan_radix(n, s - 1);
}
// offset of stage s's table (stages 1.. have one, laid out [q * Ns + m])
__host__ __device__ constexpr int plan_tw_offset(int n, int s) {
  return s <= 1 ? 0
                : plan_tw_offset(n, s - 1) +
                      plan_span(n, s - 1) * plan_radix(n, s - 1);
}
__host__ __device__ constexpr int plan_tw_size(int n) {
  return plan_tw_offset(n, plan_stages(n));
}
constexpr int plan_code(int n) {
  return plan_radix(n, 0) |
         (plan_stages(n) > 1 ? plan_radix(n, 1) << 8 : 0) |
         (plan_stages(n) > 2 ? plan_radix(n, 2) << 16 : 0);
}

// --- complex arithmetic and the in-register DFTs ---

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, -a.y * b.y), fmaf(a.x, b.y, a.y * b.x));
}
// a * conj(b)
__device__ __forceinline__ float2 cmulc(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, a.y * b.y), fmaf(a.y, b.x, -a.x * b.y));
}

// exp(-2 pi i k / 16) for 0 <= k < 8; k is a constant after unrolling.
__device__ __forceinline__ float2 root16(int k) {
  constexpr float c1 = 0.92387953251128674f;  // cos(pi/8)
  constexpr float s1 = 0.38268343236508978f;  // sin(pi/8)
  constexpr float h = 0.70710678118654752f;
  switch (k) {
    case 0: return make_float2(1.f, 0.f);
    case 1: return make_float2(c1, -s1);
    case 2: return make_float2(h, -h);
    case 3: return make_float2(s1, -c1);
    case 4: return make_float2(0.f, -1.f);
    case 5: return make_float2(-s1, -c1);
    case 6: return make_float2(-h, -h);
    default: return make_float2(-c1, -s1);
  }
}

// In-register R-point DFT (R <= 16) of v[base .. base + R): bit reversal,
// then a radix-2 decimation-in-time network. Every index is a constant
// once the callers' loops are unrolled, so v stays in registers.
template <int R, bool INV, int P>
__device__ __forceinline__ void dft(float2 (&v)[P], int base) {
  constexpr int LG = R == 2 ? 1 : R == 4 ? 2 : R == 8 ? 3 : R == 16 ? 4 : 0;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    int j = 0;
#pragma unroll
    for (int b = 0; b < LG; ++b) j |= ((i >> b) & 1) << (LG - 1 - b);
    if (i < j) {
      const float2 t = v[base + i];
      v[base + i] = v[base + j];
      v[base + j] = t;
    }
  }
#pragma unroll
  for (int st = 0; st < LG; ++st) {
    const int half = 1 << st;
#pragma unroll
    for (int i = 0; i < R / 2; ++i) {
      const int p = i & (half - 1);
      const int k = (i >> st) << (st + 1);
      const float2 a = v[base + k + p];
      float2 b = v[base + k + p + half];
      if (p != 0) {
        const float2 w = root16(p * 8 / half);
        b = INV ? cmulc(b, w) : cmul(b, w);
      }
      v[base + k + p] = make_float2(a.x + b.x, a.y + b.y);
      v[base + k + p + half] = make_float2(a.x - b.x, a.y - b.y);
    }
  }
}

// --- lines in shared memory ---

// A row tile: line l of length N at l * LS, 16 bytes of padding per 16
// points from N = 32 up (16-byte chunks stay aligned for cp.async).
template <int N>
struct RowLine {
  static constexpr int kPad = N >= 32 ? 2 : 0;
  static constexpr int LS = N + kPad * (N / 16);
  float2* p;
  static __device__ __forceinline__ int at(int e) {
    return e + kPad * (e >> 4);
  }
  __device__ __forceinline__ float2& operator[](int e) const {
    return p[at(e)];
  }
};

// A column strip: point e of column c at e * stride + c.
struct ColLine {
  float2* p;
  int stride;
  __device__ __forceinline__ float2& operator[](int e) const {
    return p[e * stride];
  }
};

// Stage ST of the Stockham plan: the thread's P / r butterflies are
// j = t + b * TPL; butterfly j reads points j + q * N / r, twiddles them by
// exp(-+2 pi i m q / (Ns r)), m = j mod Ns, runs an r-point DFT and writes
// point q to (j / Ns) * Ns * r + m + q * Ns.
template <int N, int ST, class Line>
__device__ __forceinline__ void load_stage(const Line& ln, int t,
                                           float2 (&v)[plan_points(N)]) {
  constexpr int r = plan_radix(N, ST), P = plan_points(N), TPL = N / P;
#pragma unroll
  for (int b = 0; b < P / r; ++b)
#pragma unroll
    for (int q = 0; q < r; ++q) v[b * r + q] = ln[t + b * TPL + q * (N / r)];
}

template <int N, int ST, bool INV>
__device__ __forceinline__ void compute_stage(int t, const float2* tw,
                                              float2 (&v)[plan_points(N)]) {
  constexpr int r = plan_radix(N, ST), P = plan_points(N), TPL = N / P;
  constexpr int ns = plan_span(N, ST);
#pragma unroll
  for (int b = 0; b < P / r; ++b) {
    if constexpr (ns > 1) {
      const float2* w = tw + plan_tw_offset(N, ST) + (t + b * TPL) % ns;
#pragma unroll
      for (int q = 1; q < r; ++q)
        v[b * r + q] = INV ? cmulc(v[b * r + q], w[q * ns])
                           : cmul(v[b * r + q], w[q * ns]);
    }
    dft<r, INV>(v, b * r);
  }
}

template <int N, int ST, class Line>
__device__ __forceinline__ void store_stage(const Line& ln, int t,
                                            const float2 (&v)[plan_points(N)]) {
  constexpr int r = plan_radix(N, ST), P = plan_points(N), TPL = N / P;
  constexpr int ns = plan_span(N, ST);
#pragma unroll
  for (int b = 0; b < P / r; ++b) {
    const int j = t + b * TPL;
    const int d = (j / ns) * ns * r + j % ns;
#pragma unroll
    for (int q = 0; q < r; ++q) ln[d + q * ns] = v[b * r + q];
  }
}

// The whole line transform, from the line in shared memory to registers:
// v[b * r + q] ends as point t + b * TPL + q * (N / r) of the result
// (r the last radix). Block-wide barriers between stages: every thread of
// the block calls it.
template <int N, bool INV, class Line>
__device__ __forceinline__ void fft_regs(const Line& ln, int t,
                                         const float2* tw,
                                         float2 (&v)[plan_points(N)]) {
  load_stage<N, 0>(ln, t, v);
  compute_stage<N, 0, INV>(t, tw, v);
  if constexpr (plan_stages(N) > 1) {
    __syncthreads();
    store_stage<N, 0>(ln, t, v);
    __syncthreads();
    load_stage<N, 1>(ln, t, v);
    compute_stage<N, 1, INV>(t, tw, v);
  }
  if constexpr (plan_stages(N) > 2) {
    __syncthreads();
    store_stage<N, 1>(ln, t, v);
    __syncthreads();
    load_stage<N, 2>(ln, t, v);
    compute_stage<N, 2, INV>(t, tw, v);
  }
}

// --- cp.async ---

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait0() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void load_twiddles(float2* tw,
                                              const float2* __restrict__ g) {
  for (int i = threadIdx.x; i < plan_tw_size(N); i += blockDim.x) tw[i] = g[i];
}

// --- passes 1 and 3: FFT along W of whole rows, times `scale` ---

template <int N>
struct RowTile {
  static constexpr int P = plan_points(N);
  static constexpr int TPL = N / P;             // threads per line
  static constexpr int L = kRowThreads / TPL;   // lines per tile
  static constexpr int kElems = L * RowLine<N>::LS;
  static constexpr int kSmem = (2 * kElems + plan_tw_size(N)) * 8;
};

template <int N>
__device__ __forceinline__ void stage_rows(const float2* __restrict__ in,
                                           float2* s, long tile, long rows) {
  using T = RowTile<N>;
  const long r0 = tile * T::L;
  const int lines = rows - r0 < T::L ? (int)(rows - r0) : T::L;
  const float2* src = in + r0 * N;
  for (int i = threadIdx.x; i < lines * N / 2; i += kRowThreads) {
    const int e0 = 2 * i;
    cp_async16(s + (e0 / N) * RowLine<N>::LS + RowLine<N>::at(e0 % N),
               src + e0);
  }
}

template <int N, bool INVERSE>
__global__ void __launch_bounds__(kRowThreads)
row_fft(const float2* __restrict__ in, float2* __restrict__ out, long rows,
        const float2* __restrict__ tw_g, float scale) {
  using T = RowTile<N>;
  extern __shared__ __align__(16) float2 smem[];
  float2* tw = smem + 2 * T::kElems;
  load_twiddles<N>(tw, tw_g);
  const long tiles = (rows + T::L - 1) / T::L;
  const int line = threadIdx.x / T::TPL, t = threadIdx.x % T::TPL;
  long tile = blockIdx.x;
  if (tile < tiles) stage_rows<N>(in, smem, tile, rows);
  cp_async_commit();
  for (int buf = 0; tile < tiles; tile += gridDim.x, buf ^= 1) {
    const long next = tile + gridDim.x;
    if (next < tiles)
      stage_rows<N>(in, smem + (buf ^ 1) * T::kElems, next, rows);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    float2* s = smem + buf * T::kElems;
    const RowLine<N> ln{s + line * RowLine<N>::LS};
    float2 v[T::P];
    fft_regs<N, INVERSE>(ln, t, tw, v);
    __syncthreads();
    store_stage<N, plan_stages(N) - 1>(ln, t, v);
    __syncthreads();
    const long r0 = tile * T::L;
    const int lines = rows - r0 < T::L ? (int)(rows - r0) : T::L;
    float4* dst = reinterpret_cast<float4*>(out + r0 * N);
    for (int i = threadIdx.x; i < lines * N / 2; i += kRowThreads) {
      const int e0 = 2 * i;
      const float2* p = s + (e0 / N) * RowLine<N>::LS + RowLine<N>::at(e0 % N);
      dst[i] = make_float4(p[0].x * scale, p[0].y * scale, p[1].x * scale,
                           p[1].y * scale);
    }
    __syncthreads();
  }
}

// --- pass 2: column FFT, merge, inverse column FFT, in place ---

template <int H>
struct ColPlan {
  static constexpr int P = plan_points(H);
  static constexpr int TPL = H / P;
  static constexpr int S = plan_stages(H);
  static constexpr int RL = plan_radix(H, S - 1);  // the last radix
  static constexpr int kStrip = col_strip(H);
  static constexpr int kThreads = kStrip * TPL;
};

// A strip: `cols` columns of one image, all H rows, row-major in smem.
template <int H>
__device__ __forceinline__ void stage_cols(const float2* t,
                                           float2* s, int tile, int tiles_w,
                                           int w, int cols) {
  const size_t base =
      (size_t)(tile / tiles_w) * H * w + (tile % tiles_w) * cols;
  const int per_row = cols / 2;
  for (int i = threadIdx.x; i < H * per_row; i += blockDim.x) {
    const int r = i / per_row, c = 2 * (i % per_row);
    cp_async16(s + r * cols + c, t + base + (size_t)r * w + c);
  }
}

// `in` and `out` may be one buffer (dc_forward runs the pass in place):
// a strip is read whole before its own output is written, and no other
// strip reads it.
template <int H, bool HAS_K0>
__global__ void __launch_bounds__(ColPlan<H>::kThreads)
col_dc(const float2* in, float2* out, const float2* __restrict__ k0,
       const float* __restrict__ mask, int batch, int w,
       const float2* __restrict__ tw_g, float scale) {
  using CP = ColPlan<H>;
  constexpr int P = CP::P, TPL = CP::TPL, RL = CP::RL;
  constexpr int kSpan = H / RL;   // Ns of the last stage
  constexpr bool kPrefetch = H <= 256;
  const int cols = w < CP::kStrip ? w : CP::kStrip;
  const int elems = H * cols;
  extern __shared__ __align__(16) float2 smem[];
  float2* tw = smem + 2 * elems;
  load_twiddles<H>(tw, tw_g);
  const int tiles_w = w / cols;
  const int tiles = batch * tiles_w;
  const int c = threadIdx.x % cols, tt = threadIdx.x / cols;
  int tile = blockIdx.x;
  if (tile < tiles) stage_cols<H>(in, smem, tile, tiles_w, w, cols);
  cp_async_commit();
  for (int buf = 0; tile < tiles; tile += gridDim.x, buf ^= 1) {
    const int next = tile + gridDim.x;
    if (next < tiles)
      stage_cols<H>(in, smem + (buf ^ 1) * elems, next, tiles_w, w, cols);
    cp_async_commit();
    // The merge operands of the points this thread will hold after the
    // forward transform: rows tt + b * TPL + q * kSpan of column c. Loaded
    // before the transform up to H = 256; at 512 (1024 threads, 64
    // registers each) and 1024 (512 threads, 16 points each) they would
    // spill, and are loaded at the merge.
    const size_t col0 = (size_t)(tile / tiles_w) * H * w +
                        (tile % tiles_w) * cols + c;
    float keep[P];
    float2 kk[P];
    auto load_merge = [&]() {
#pragma unroll
      for (int b = 0; b < P / RL; ++b)
#pragma unroll
        for (int q = 0; q < RL; ++q) {
          const size_t g = col0 + (size_t)(tt + b * TPL + q * kSpan) * w;
          keep[b * RL + q] = 1.f - __ldg(mask + g);
          kk[b * RL + q] = HAS_K0 ? __ldg(k0 + g) : make_float2(0.f, 0.f);
        }
    };
    if constexpr (kPrefetch) load_merge();
    cp_async_wait1();
    __syncthreads();
    float2* s = smem + buf * elems;
    const ColLine ln{s + c, cols};
    float2 v[P];
    fft_regs<H, false>(ln, tt, tw, v);
    if constexpr (!kPrefetch) load_merge();
#pragma unroll
    for (int i = 0; i < P; ++i)
      v[i] = make_float2(fmaf(keep[i], v[i].x * scale, kk[i].x),
                         fmaf(keep[i], v[i].y * scale, kk[i].y));
    __syncthreads();
    store_stage<H, CP::S - 1>(ln, tt, v);
    __syncthreads();
    fft_regs<H, true>(ln, tt, tw, v);
    __syncthreads();
    store_stage<H, CP::S - 1>(ln, tt, v);
    __syncthreads();
    const int per_row = cols / 2;
    float2* dst = out + col0 - c;
    for (int i = threadIdx.x; i < H * per_row; i += blockDim.x) {
      const int r = i / per_row, cc = 2 * (i % per_row);
      const float2* p = s + r * cols + cc;
      *reinterpret_cast<float4*>(dst + (size_t)r * w + cc) =
          make_float4(p[0].x * scale, p[0].y * scale, p[1].x * scale,
                      p[1].y * scale);
    }
    __syncthreads();
  }
}

// --- launches ---

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

// Grid of a tile-walking kernel: as many blocks as fit on the card at
// once, at most one per tile.
template <typename K>
int walk_grid(K kern, int threads, int smem, long tiles, unsigned* grid) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long fit = (long)per_sm * sm_count();
  *grid = (unsigned)(tiles < fit ? tiles : fit);
  return 0;
}

template <int N, bool INVERSE>
int launch_rows(const float2* in, float2* out, long rows, const float2* tw,
                float scale, cudaStream_t st) {
  using T = RowTile<N>;
  auto kern = row_fft<N, INVERSE>;
  unsigned grid = 0;
  const int err = walk_grid(kern, kRowThreads, T::kSmem,
                            (rows + T::L - 1) / T::L, &grid);
  if (err) return err;
  kern<<<grid, kRowThreads, T::kSmem, st>>>(in, out, rows, tw, scale);
  return (int)cudaGetLastError();
}

template <int H>
int launch_cols(const float2* in, float2* t, const float2* k0,
                const float* mask, int batch, int w, const float2* tw,
                float scale, cudaStream_t st) {
  constexpr int strip = ColPlan<H>::kStrip;
  const int cols = w < strip ? w : strip;
  const int threads = cols * ColPlan<H>::TPL;
  const int smem = (2 * H * cols + plan_tw_size(H)) * 8;
  const long tiles = (long)batch * (w / cols);
  unsigned grid = 0;
  if (k0 != nullptr) {
    auto kern = col_dc<H, true>;
    const int err = walk_grid(kern, threads, smem, tiles, &grid);
    if (err) return err;
    kern<<<grid, threads, smem, st>>>(in, t, k0, mask, batch, w, tw, scale);
  } else {
    auto kern = col_dc<H, false>;
    const int err = walk_grid(kern, threads, smem, tiles, &grid);
    if (err) return err;
    kern<<<grid, threads, smem, st>>>(in, t, nullptr, mask, batch, w, tw,
                                      scale);
  }
  return (int)cudaGetLastError();
}

template <bool INVERSE>
int rows_pass(int n, const float2* in, float2* out, long rows,
              const float2* tw, float scale, cudaStream_t st) {
  switch (n) {
    case 2: return launch_rows<2, INVERSE>(in, out, rows, tw, scale, st);
    case 4: return launch_rows<4, INVERSE>(in, out, rows, tw, scale, st);
    case 8: return launch_rows<8, INVERSE>(in, out, rows, tw, scale, st);
    case 16: return launch_rows<16, INVERSE>(in, out, rows, tw, scale, st);
    case 32: return launch_rows<32, INVERSE>(in, out, rows, tw, scale, st);
    case 64: return launch_rows<64, INVERSE>(in, out, rows, tw, scale, st);
    case 128: return launch_rows<128, INVERSE>(in, out, rows, tw, scale, st);
    case 256: return launch_rows<256, INVERSE>(in, out, rows, tw, scale, st);
    case 512: return launch_rows<512, INVERSE>(in, out, rows, tw, scale, st);
    case 1024: return launch_rows<1024, INVERSE>(in, out, rows, tw, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

int cols_pass(int h, const float2* in, float2* t, const float2* k0,
              const float* mask, int batch, int w, const float2* tw,
              float scale, cudaStream_t st) {
  switch (h) {
#define CSMRI_COLS(n) \
    case n: return launch_cols<n>(in, t, k0, mask, batch, w, tw, scale, st);
    CSMRI_COLS(2) CSMRI_COLS(4) CSMRI_COLS(8) CSMRI_COLS(16) CSMRI_COLS(32)
    CSMRI_COLS(64) CSMRI_COLS(128) CSMRI_COLS(256) CSMRI_COLS(512)
    CSMRI_COLS(1024)
#undef CSMRI_COLS
  }
  return (int)cudaErrorInvalidValue;
}

bool supported(int n, int code) {
  return n >= 2 && n <= kTileLine && !(n & (n - 1)) && code == plan_code(n);
}

// --- dense DFT lines (sides with a prime factor above 13) ---

constexpr int kDftThreads = 256;

// One line of n points from shared memory (element e at e * stride):
// out(k) = sum_j line(j) w^(j k), w = tw[1] (conjugated for the inverse).
template <bool INV>
__device__ __forceinline__ float2 dft_point(const float2* line, int stride,
                                            const float2* tw, int n, int k) {
  float2 acc = make_float2(0.f, 0.f);
  int idx = 0;
  for (int j = 0; j < n; ++j) {
    const float2 v = line[j * stride];
    const float2 w = tw[idx];
    acc.x = fmaf(v.x, w.x, INV ? fmaf(v.y, w.y, acc.x) : fmaf(-v.y, w.y, acc.x));
    acc.y = fmaf(v.y, w.x, INV ? fmaf(-v.x, w.y, acc.y) : fmaf(v.x, w.y, acc.y));
    idx += k;
    if (idx >= n) idx -= n;
  }
  return acc;
}

// Passes 1 and 3: the DFT along W of each of `rows` rows, times `scale`.
template <bool INV>
__global__ void __launch_bounds__(kDftThreads)
dft_rows(const float2* __restrict__ in, float2* __restrict__ out, long rows,
         int n, const float2* __restrict__ tw_g, float scale) {
  extern __shared__ __align__(16) float2 smem[];
  float2* tw = smem;
  float2* line = smem + n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) tw[i] = tw_g[i];
  for (long r = blockIdx.x; r < rows; r += gridDim.x) {
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x) line[i] = in[r * n + i];
    __syncthreads();
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
      const float2 v = dft_point<INV>(line, 1, tw, n, k);
      out[r * n + k] = make_float2(v.x * scale, v.y * scale);
    }
  }
}

// Pass 2: per strip of up to STRIP columns of one image (col_strip(h)),
// the DFT along H (h points, roots tw_g), the merge (1 - m) k + k0, the
// inverse DFT along H, from `in` to `out` (one buffer in dc_forward: a
// strip is read whole before it is written).
template <bool HAS_K0, int STRIP>
__global__ void __launch_bounds__(kDftThreads)
dft_cols(const float2* in, float2* out, const float2* __restrict__ k0,
         const float* __restrict__ mask, int batch, int h, int w,
         const float2* __restrict__ tw_g, float scale) {
  extern __shared__ __align__(16) float2 smem[];
  float2* tw = smem;
  float2* a = smem + h;              // the strip, h rows of STRIP
  float2* b = a + h * STRIP;         // its merged k-space
  for (int i = threadIdx.x; i < h; i += blockDim.x) tw[i] = tw_g[i];
  const int groups = (w + STRIP - 1) / STRIP;
  for (int tile = blockIdx.x; tile < batch * groups; tile += gridDim.x) {
    const int c0 = (tile % groups) * STRIP;
    const int cols = w - c0 < STRIP ? w - c0 : STRIP;
    const size_t base = (size_t)(tile / groups) * h * w + c0;
    __syncthreads();
    for (int i = threadIdx.x; i < h * cols; i += blockDim.x)
      a[(i / cols) * STRIP + i % cols] =
          in[base + (size_t)(i / cols) * w + i % cols];
    __syncthreads();
    for (int i = threadIdx.x; i < h * cols; i += blockDim.x) {
      const int k = i / cols, c = i % cols;
      const size_t g = base + (size_t)k * w + c;
      const float2 v = dft_point<false>(a + c, STRIP, tw, h, k);
      const float keep = 1.f - __ldg(mask + g);
      const float2 kk = HAS_K0 ? __ldg(k0 + g) : make_float2(0.f, 0.f);
      b[k * STRIP + c] = make_float2(fmaf(keep, v.x * scale, kk.x),
                                     fmaf(keep, v.y * scale, kk.y));
    }
    __syncthreads();
    for (int i = threadIdx.x; i < h * cols; i += blockDim.x) {
      const int k = i / cols, c = i % cols;
      const float2 v = dft_point<true>(b + c, STRIP, tw, h, k);
      out[base + (size_t)k * w + c] = make_float2(v.x * scale, v.y * scale);
    }
  }
}

// The dense route's passes 1 and 3 (INV) on `rows` lines of n points.
template <bool INV>
int dft_rows_pass(const float2* in, float2* out, long rows, int n,
                  const float2* roots, float scale, cudaStream_t st) {
  unsigned grid = 0;
  const int smem = 2 * n * 8;
  const int err = walk_grid(dft_rows<INV>, kDftThreads, smem, rows, &grid);
  if (err) return err;
  dft_rows<INV><<<grid, kDftThreads, smem, st>>>(in, out, rows, n, roots,
                                                 scale);
  return (int)cudaGetLastError();
}

// The dense route's pass 2 on (batch, h, w) images, in strips of STRIP
// columns.
template <int STRIP>
int dft_cols_strips(const float2* in, float2* out, const float2* k0,
                    const float* mask, int batch, int h, int w,
                    const float2* roots, float scale, cudaStream_t st) {
  unsigned grid = 0;
  const int smem = (h + 2 * h * STRIP) * 8;
  const long strips = (long)batch * ((w + STRIP - 1) / STRIP);
  if (k0 != nullptr) {
    auto kern = dft_cols<true, STRIP>;
    const int err = walk_grid(kern, kDftThreads, smem, strips, &grid);
    if (err) return err;
    kern<<<grid, kDftThreads, smem, st>>>(in, out, k0, mask, batch, h, w,
                                          roots, scale);
  } else {
    auto kern = dft_cols<false, STRIP>;
    const int err = walk_grid(kern, kDftThreads, smem, strips, &grid);
    if (err) return err;
    kern<<<grid, kDftThreads, smem, st>>>(in, out, nullptr, mask, batch, h,
                                          w, roots, scale);
  }
  return (int)cudaGetLastError();
}

int dft_cols_pass(const float2* in, float2* out, const float2* k0,
                  const float* mask, int batch, int h, int w,
                  const float2* roots, float scale, cudaStream_t st) {
  return col_strip(h) == 16
             ? dft_cols_strips<16>(in, out, k0, mask, batch, h, w, roots,
                                   scale, st)
             : dft_cols_strips<8>(in, out, k0, mask, batch, h, w, roots,
                                  scale, st);
}

// --- mixed-radix lines (sides whose prime factors are at most 13) ---
//
// A plan is a runtime argument (ops/dc_kernel.py::mixed_plan, one byte
// per stage's radix), run by one stage function per radix: the radix-2
// networks of 2 to 16 points above, and odd DFTs of 3 to 15 points with
// constant roots. A tile of lines sits in shared memory with the line
// index fastest (point e of line l at e * cs + l), and each stage hands
// its butterflies out over the whole block: butterfly i is j = i / lines
// of line i % lines, so a half-warp works on 16 (8) neighbouring lines at
// one j and reads and writes neighbouring words whatever the stage's
// strides, odd or not. A stage reads one buffer and writes another
// (Stockham ping-pong: no register array sized by the plan), then the
// block syncs. The pass's staging is the radix route's: cp.async (8
// bytes, since a row tile is stored transposed) of the next tile while
// the block transforms the current one.

constexpr int kMixThreads = 256;
constexpr int kMaxStages = 4;   // ops/dc_kernel.py::MIXED_MAX_STAGES

struct MixPlan {
  int n, stages, tw_size;
  int radix[kMaxStages];
  int span[kMaxStages];     // Ns: the product of the earlier radices
  int tw_off[kMaxStages];   // stage s >= 1's table, [q * Ns + m]
};

constexpr bool mix_radix(int r) {
  return r == 2 || r == 3 || r == 4 || r == 5 || r == 7 || r == 8 ||
         r == 9 || r == 11 || r == 13 || r == 15 || r == 16;
}

// Decode and check a plan code: radices of the set, product n (a line of
// at most kStageLine points).
bool mix_plan(int n, unsigned long long code, MixPlan* p) {
  if (n < 2 || n > kStageLine) return false;
  p->n = n;
  p->stages = 0;
  int span = 1, off = 0;
  for (int s = 0; s < 8; ++s) {
    const int r = (int)((code >> (8 * s)) & 255);
    if (r == 0) break;
    if (s >= kMaxStages || !mix_radix(r)) return false;
    p->radix[s] = r;
    p->span[s] = span;
    p->tw_off[s] = off;
    if (s) off += span * r;
    span *= r;
    p->stages = s + 1;
  }
  p->tw_size = off;
  return p->stages > 0 && span == n && (code >> (8 * p->stages)) == 0;
}

// (cos, sin) of 2 pi m / R for R odd and 0 < m <= (R - 1) / 2, in f64
// rounded once to f32 (ops/dc_kernel.py::odd_roots); r * 8 + m is a
// constant once the callers' loops are unrolled.
__device__ __forceinline__ float2 odd_root(int r, int m) {
  switch (r * 8 + m) {
    case 25: return make_float2(-0.5f, 0.8660253882408142f);
    case 41: return make_float2(0.30901700258255005f, 0.9510565400123596f);
    case 42: return make_float2(-0.80901700258255f, 0.5877852439880371f);
    case 57: return make_float2(0.6234897971153259f, 0.7818315029144287f);
    case 58: return make_float2(-0.22252093255519867f, 0.9749279022216797f);
    case 59: return make_float2(-0.9009688496589661f, 0.4338837265968323f);
    case 73: return make_float2(0.7660444378852844f, 0.6427876353263855f);
    case 74: return make_float2(0.1736481785774231f, 0.9848077297210693f);
    case 75: return make_float2(-0.5f, 0.8660253882408142f);
    case 76: return make_float2(-0.9396926164627075f, 0.3420201539993286f);
    case 89: return make_float2(0.8412535190582275f, 0.5406408309936523f);
    case 90: return make_float2(0.4154150187969208f, 0.9096319675445557f);
    case 91: return make_float2(-0.1423148363828659f, 0.9898214340209961f);
    case 92: return make_float2(-0.6548607349395752f, 0.7557495832443237f);
    case 93: return make_float2(-0.9594929814338684f, 0.28173255920410156f);
    case 105: return make_float2(0.8854560256004333f, 0.4647231698036194f);
    case 106: return make_float2(0.5680647492408752f, 0.8229838609695435f);
    case 107: return make_float2(0.1205366775393486f, 0.9927088618278503f);
    case 108: return make_float2(-0.35460489988327026f, 0.9350162148475647f);
    case 109: return make_float2(-0.7485107779502869f, 0.6631226539611816f);
    case 110: return make_float2(-0.9709418416023254f, 0.23931565880775452f);
    case 121: return make_float2(0.9135454297065735f, 0.4067366421222687f);
    case 122: return make_float2(0.6691306233406067f, 0.7431448101997375f);
    case 123: return make_float2(0.30901700258255005f, 0.9510565400123596f);
    case 124: return make_float2(-0.10452846437692642f, 0.9945219159126282f);
    case 125: return make_float2(-0.5f, 0.8660253882408142f);
    case 126: return make_float2(-0.80901700258255f, 0.5877852439880371f);
    case 127: return make_float2(-0.9781476259231567f, 0.2079116851091385f);
  }
  return make_float2(1.f, 0.f);
}

// In-register odd R-point DFT: with a_j = v_j + v_(R-j), b_j = v_j -
// v_(R-j), y_k = v_0 + sum_j a_j cos(2 pi jk / R) -+ i sum_j b_j sin(...)
// and y_(R-k) the other sign: (R - 1)^2 real FMAs per component.
template <int R, bool INV>
__device__ __forceinline__ void odd_dft(float2 (&v)[R]) {
  constexpr int H = (R - 1) / 2;
  float2 a[H], b[H];
  float2 y0 = v[0];
#pragma unroll
  for (int j = 1; j <= H; ++j) {
    a[j - 1] = make_float2(v[j].x + v[R - j].x, v[j].y + v[R - j].y);
    b[j - 1] = make_float2(v[j].x - v[R - j].x, v[j].y - v[R - j].y);
    y0 = make_float2(y0.x + a[j - 1].x, y0.y + a[j - 1].y);
  }
#pragma unroll
  for (int k = 1; k <= H; ++k) {
    float2 c = v[0];
    float2 t = make_float2(0.f, 0.f);
#pragma unroll
    for (int j = 1; j <= H; ++j) {
      const int m = j * k % R;
      if (m == 0) {   // R = 9 or 15: cos 1, sin 0
        c = make_float2(c.x + a[j - 1].x, c.y + a[j - 1].y);
        continue;
      }
      const float2 w = odd_root(R, m <= H ? m : R - m);
      const float sn = m <= H ? w.y : -w.y;
      c = make_float2(fmaf(a[j - 1].x, w.x, c.x), fmaf(a[j - 1].y, w.x, c.y));
      t = make_float2(fmaf(b[j - 1].x, sn, t.x), fmaf(b[j - 1].y, sn, t.y));
    }
    // forward: y_k = c - i t, y_(R-k) = c + i t; the inverse conjugates
    const float2 minus = make_float2(c.x + t.y, c.y - t.x);
    const float2 plus = make_float2(c.x - t.y, c.y + t.x);
    v[k] = INV ? plus : minus;
    v[R - k] = INV ? minus : plus;
  }
  v[0] = y0;
}

template <int R, bool INV>
__device__ __forceinline__ void small_dft(float2 (&v)[R]) {
  if constexpr (R & 1)
    odd_dft<R, INV>(v);
  else
    dft<R, INV>(v, 0);
}

// One Stockham stage of radix R on `lines` = 1 << lg lines of n points,
// from src to dst (tile layout above): butterfly j of a line reads points
// j + q * n / R, twiddles them by exp(-+2 pi i k q / (Ns R)), k = j mod Ns,
// runs the R-point DFT and writes point q to (j - k) R + k + q Ns.
template <int R, bool INV>
__device__ __forceinline__ void mix_stage(const float2* src, float2* dst,
                                          int n, int ns, const float2* tw,
                                          int lg, int cs) {
  const int m = n / R;
  const int count = m << lg;
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    const int l = i & ((1 << lg) - 1), j = i >> lg;
    float2 v[R];
#pragma unroll
    for (int q = 0; q < R; ++q) v[q] = src[(j + q * m) * cs + l];
    const int k = j % ns;
    if (ns > 1) {
#pragma unroll
      for (int q = 1; q < R; ++q)
        v[q] = INV ? cmulc(v[q], tw[q * ns + k]) : cmul(v[q], tw[q * ns + k]);
    }
    small_dft<R, INV>(v);
    const int d = (j - k) * R + k;
#pragma unroll
    for (int q = 0; q < R; ++q) dst[(d + q * ns) * cs + l] = v[q];
  }
}

// The whole line transform of a tile: the plan's stages between buffers a
// and b, a block-wide barrier after each. Returns the buffer that holds
// the result (a or b). Every thread of the block calls it.
template <bool INV>
__device__ __forceinline__ float2* mix_fft(float2* a, float2* b,
                                           const MixPlan& p,
                                           const float2* tw, int lg,
                                           int cs) {
  for (int s = 0; s < p.stages; ++s) {
    const float2* t = tw + p.tw_off[s];
    const int ns = p.span[s];
    switch (p.radix[s]) {
#define CSMRI_STAGE(r) \
      case r: mix_stage<r, INV>(a, b, p.n, ns, t, lg, cs); break;
      CSMRI_STAGE(2) CSMRI_STAGE(3) CSMRI_STAGE(4) CSMRI_STAGE(5)
      CSMRI_STAGE(7) CSMRI_STAGE(8) CSMRI_STAGE(9) CSMRI_STAGE(11)
      CSMRI_STAGE(13) CSMRI_STAGE(15) CSMRI_STAGE(16)
#undef CSMRI_STAGE
    }
    __syncthreads();
    float2* c = a;
    a = b;
    b = c;
  }
  return a;
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

// The plan and twiddles into shared memory (the plan's arrays are indexed
// by the stage, a runtime value).
__device__ __forceinline__ void mix_setup(MixPlan* sp, const MixPlan& p,
                                          float2* tw,
                                          const float2* __restrict__ g) {
  if (threadIdx.x == 0) *sp = p;
  for (int i = threadIdx.x; i < p.tw_size; i += blockDim.x) tw[i] = g[i];
}

// Passes 1 and 3: a tile is 1 << lg rows of n points, stored transposed
// (cs = (1 << lg) + 1, odd: staging a row's neighbouring points hits
// every bank); `lines` of them are real (the last tile may be partial, and
// its other lines are transformed and dropped).
__device__ __forceinline__ void mix_stage_rows(const float2* __restrict__ in,
                                               float2* s, long r0, int lines,
                                               int n, int cs) {
  const float2* src = in + r0 * n;
  for (int i = threadIdx.x; i < lines * n; i += blockDim.x) {
    const int l = i / n, e = i - l * n;
    cp_async8(s + e * cs + l, src + i);
  }
}

template <bool INV>
__global__ void __launch_bounds__(kMixThreads)
mix_rows(const float2* __restrict__ in, float2* __restrict__ out, long rows,
         MixPlan p, const float2* __restrict__ tw_g, float scale, int lg) {
  __shared__ MixPlan sp;
  extern __shared__ __align__(16) float2 smem[];
  const int n = p.n, tl = 1 << lg, cs = tl + 1, elems = n * cs;
  float2* tw = smem + 3 * elems;
  mix_setup(&sp, p, tw, tw_g);
  const long tiles = (rows + tl - 1) / tl;
  auto lines_of = [&](long tile) {
    return rows - tile * tl < tl ? (int)(rows - tile * tl) : tl;
  };
  long tile = blockIdx.x;
  if (tile < tiles) mix_stage_rows(in, smem, tile * tl, lines_of(tile), n, cs);
  cp_async_commit();
  for (int buf = 0; tile < tiles; tile += gridDim.x, buf ^= 1) {
    const long next = tile + gridDim.x;
    if (next < tiles)
      mix_stage_rows(in, smem + (buf ^ 1) * elems, next * tl, lines_of(next),
                     n, cs);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    const float2* s =
        mix_fft<INV>(smem + buf * elems, smem + 2 * elems, sp, tw, lg, cs);
    const int lines = lines_of(tile);
    float2* dst = out + tile * tl * n;
    for (int i = threadIdx.x; i < lines * n; i += blockDim.x) {
      const int l = i / n, e = i - l * n;
      const float2 v = s[e * cs + l];
      dst[i] = make_float2(v.x * scale, v.y * scale);
    }
    __syncthreads();
  }
}

// Pass 2: per strip of up to 1 << LG columns of one image (8 columns,
// 64-byte row segments, up to h = 512; 4 above, where three 8-column
// buffers of 1024 rows would take 196 KB; point e of column c at
// e * strip + c), the FFT along H, the merge (1 - m) k + k0 (operands
// loaded before the forward transform, kMerge rows a thread), the inverse
// FFT along H, from `in` to `out` (one buffer in dc_forward: a strip is
// read whole before it is written). A thread keeps one column c of every
// strip; threads of columns past a partial strip's stage, merge and write
// nothing, and their lines are transformed and dropped.
constexpr int kMerge = 16;   // rows a thread merges: h * strip / threads

template <bool HAS_K0, int LG>
__global__ void __launch_bounds__(kMixThreads)
mix_cols(const float2* in, float2* out, const float2* __restrict__ k0,
         const float* __restrict__ mask, int batch, int w, MixPlan p,
         const float2* __restrict__ tw_g, float scale) {
  constexpr int lg = LG, strip = 1 << lg;
  __shared__ MixPlan sp;
  extern __shared__ __align__(16) float2 smem[];
  const int h = p.n, elems = h * strip;
  float2* tw = smem + 3 * elems;
  mix_setup(&sp, p, tw, tw_g);
  const int groups = (w + strip - 1) / strip;
  const int tiles = batch * groups;
  const int c = threadIdx.x & (strip - 1), e0 = threadIdx.x >> lg;
  const int step = blockDim.x >> lg;
  auto base_of = [&](int tile) {
    return (size_t)(tile / groups) * h * w + (size_t)(tile % groups) * strip;
  };
  auto cols_of = [&](int tile) {
    const int c0 = (tile % groups) * strip;
    return w - c0 < strip ? w - c0 : strip;
  };
  auto stage = [&](int tile, float2* s) {
    if (c < cols_of(tile)) {
      const float2* src = in + base_of(tile) + c;
      for (int e = e0; e < h; e += step)
        cp_async8(s + e * strip + c, src + (size_t)e * w);
    }
  };
  int tile = blockIdx.x;
  if (tile < tiles) stage(tile, smem);
  cp_async_commit();
  for (int buf = 0; tile < tiles; tile += gridDim.x, buf ^= 1) {
    const int next = tile + gridDim.x;
    if (next < tiles) stage(next, smem + (buf ^ 1) * elems);
    cp_async_commit();
    const bool mine = c < cols_of(tile);
    const size_t col = base_of(tile) + c;
    float keep[kMerge];
    float2 kk[kMerge];
#pragma unroll
    for (int i = 0; i < kMerge; ++i) {
      const int e = e0 + i * step;
      if (mine && e < h) {
        keep[i] = 1.f - __ldg(mask + col + (size_t)e * w);
        kk[i] = HAS_K0 ? __ldg(k0 + col + (size_t)e * w)
                       : make_float2(0.f, 0.f);
      }
    }
    cp_async_wait1();
    __syncthreads();
    float2* cur = smem + buf * elems;
    float2* work = smem + 2 * elems;
    float2* f = mix_fft<false>(cur, work, sp, tw, lg, strip);
    if (mine) {
#pragma unroll
      for (int i = 0; i < kMerge; ++i) {
        const int e = e0 + i * step;
        if (e < h) {
          float2& v = f[e * strip + c];
          v = make_float2(fmaf(keep[i], v.x * scale, kk[i].x),
                          fmaf(keep[i], v.y * scale, kk[i].y));
        }
      }
    }
    __syncthreads();
    const float2* y = mix_fft<true>(f, f == cur ? work : cur, sp, tw, lg,
                                    strip);
    if (mine) {
      float2* dst = out + col;
      for (int e = e0; e < h; e += step) {
        const float2 v = y[e * strip + c];
        dst[(size_t)e * w] = make_float2(v.x * scale, v.y * scale);
      }
    }
    __syncthreads();
  }
}

// Lines per row tile: 16 up to n = 128, 8 up to 512, 4 above. Columns
// per strip: 8 up to h = 512, 4 above. A column strip takes 128 threads
// up to h = 256 and 256 above, so that a thread merges at most kMerge
// rows. A block's three buffers stay under 134 KB (under 110 KB up to
// 512), and up to h = 256 four blocks share an SM: 240^2 at B = 20 (600
// strips, 300 a rank of two) then runs in about one wave (faster there
// than 16-column strips or 256 threads, timed in turns on one card).
int mix_row_lg(int n) { return n <= 128 ? 4 : n <= 512 ? 3 : 2; }
int mix_col_lg(int h) { return h <= 512 ? 3 : 2; }
int mix_col_threads(int h) { return h <= 256 ? 128 : 256; }

template <bool INV>
int mix_rows_pass(const float2* in, float2* out, long rows, const MixPlan& p,
                  const float2* tw, float scale, cudaStream_t st) {
  const int lg = mix_row_lg(p.n), tl = 1 << lg;
  const int smem = (3 * p.n * (tl + 1) + p.tw_size) * 8;
  unsigned grid = 0;
  const int err = walk_grid(mix_rows<INV>, kMixThreads, smem,
                            (rows + tl - 1) / tl, &grid);
  if (err) return err;
  mix_rows<INV><<<grid, kMixThreads, smem, st>>>(in, out, rows, p, tw, scale,
                                                 lg);
  return (int)cudaGetLastError();
}

template <int LG>
int mix_cols_strips(const float2* in, float2* out, const float2* k0,
                    const float* mask, int batch, int w, const MixPlan& p,
                    const float2* tw, float scale, cudaStream_t st) {
  constexpr int strip = 1 << LG;
  const int threads = mix_col_threads(p.n);
  const int smem = (3 * p.n * strip + p.tw_size) * 8;
  const long strips = (long)batch * ((w + strip - 1) / strip);
  unsigned grid = 0;
  if (k0 != nullptr) {
    auto kern = mix_cols<true, LG>;
    const int err = walk_grid(kern, threads, smem, strips, &grid);
    if (err) return err;
    kern<<<grid, threads, smem, st>>>(in, out, k0, mask, batch, w, p, tw,
                                      scale);
  } else {
    auto kern = mix_cols<false, LG>;
    const int err = walk_grid(kern, threads, smem, strips, &grid);
    if (err) return err;
    kern<<<grid, threads, smem, st>>>(in, out, nullptr, mask, batch, w, p,
                                      tw, scale);
  }
  return (int)cudaGetLastError();
}

int mix_cols_pass(const float2* in, float2* out, const float2* k0,
                  const float* mask, int batch, int w, const MixPlan& p,
                  const float2* tw, float scale, cudaStream_t st) {
  return mix_col_lg(p.n) == 3
             ? mix_cols_strips<3>(in, out, k0, mask, batch, w, p, tw, scale,
                                  st)
             : mix_cols_strips<2>(in, out, k0, mask, batch, w, p, tw, scale,
                                  st);
}

// --- Bluestein's chirp (sides with a prime factor above 13) ---
//
// With c_j = exp(i pi j^2 / n), the DFT X_k = sum_j x_j exp(-2 pi i jk / n)
// is X_k = conj(c_k) sum_j (x_j conj(c_j)) c_(k - j), since 2jk = j^2 + k^2
// - (k - j)^2: a cyclic convolution of length m (an m >= 2n - 1 whose
// prime factors are at most 13 and that has a plan, chosen by
// ops/dc_kernel.py::chirp_length) of the chirped line, zero-padded to m,
// with the filter b (b_j = c_j for 0 <= j < n and b_(m - j) = c_j for 0 < j
// < n, zero between). It runs as FFT_m, the pointwise product with F =
// FFT_m(b) / m, inverse FFT_m. The inverse DFT is the forward one
// conjugated on the way in and on the way out, so one filter serves both
// directions (so does the split route's transform).
//
// --- the chirp and split routes in one launch a pass ---
//
// block_lines: a tile of lines (rows, or kColTile adjacent columns: 32
// bytes of a row, one sector) in one buffer of a block's shared memory, a
// line's transform of N points (the chirp's m, or the split side n) in
// place: decimation in frequency (natural order in, the frequencies at
// digit-reversed positions out, ops/dc_kernel.py::line_positions) and its
// adjoint, decimation in time (those positions in, natural order out, the
// unscaled inverse), one stage function per radix (line_stage). A
// butterfly reads its R points into registers and writes its results back
// to the same positions, so a stage needs no second buffer and one
// barrier. The chirp's convolution never needs the natural order between
// its two FFTs: the host hands the filter at the digit-reversed positions.
// The split route's forward transforms leave the frequencies
// digit-reversed, and the store (passes 1 and 3) or the merge (pass 2)
// reads each at its position. The first stage reads its inputs from the
// staging area, where cp.async copied the tile's n raw points while the
// block transformed the previous tile, applies the chirp (and the
// inverse's conjugate) there, and skips the zero padding: it neither
// stages nor reads it. The last stage of the inverse writes device memory
// itself, the n points a line has, with the chirp's way out, the merge or
// the scale. Pass 2 runs the DFT along H, the merge and the inverse DFT
// along H in the same block. Twiddles: one table of the N roots
// exp(-2 pi i j / N) (stage s's W_(L_s)^(jk) is entry j k N / L_s); it,
// the chirp, the filter and the positions are read through L1 (copied to
// shared memory they were no faster on the card). A tile and its staging
// fit kBlockSmem up to a chirp length of kBlockLine (4628) and a split
// line of 3506 points.
//
// cluster_lines: a longer line is spread over the shared memory of a
// thread-block cluster of C <= kClusterMax blocks, block r holding its
// positions r N / C to (r + 1) N / C - 1 and raw points r ceil(n / C) on.
// The plan's first radix is a multiple of C, so after the first stage of
// decimation in frequency every later stage's butterflies lie in one
// block's share: only the first stage (and the inverse's last) reads and
// writes across the cluster, through distributed shared memory
// (cooperative_groups::this_cluster, map_shared_rank), between two
// cluster barriers; the rest is block_lines' code on the block's share.
// One launch carries a whole pass, and a pass reads and writes device
// memory once. Lines longer than a cluster holds run on device stages
// (stage_lines, below). What bounds both: shared-memory traffic and the
// barriers between stages, on top of a pass's bytes.

// Lines of one axis in device memory: line l's point p at
// (l / lpg) * gs + l % lpg + p * ps. Rows: lpg 1, gs the row length, ps 1;
// a block of w columns of (batch, h, w) images: lpg w, gs h * w, ps w.
struct Lines {
  long count;
  int lpg;
  long gs;
  int ps;
  __host__ __device__ long base(long l) const {
    return (l / lpg) * gs + l % lpg;
  }
};

__device__ __forceinline__ float2 conj2(float2 a) {
  return make_float2(a.x, -a.y);
}

// The launch bound of block_lines and cluster_lines: up to 1024 threads a
// block (line_threads), so at most 64 registers a thread, which keeps more
// warps an SM than 128 registers and 512 threads did, spills and all
// (timed in turns on the card).
constexpr int kLineThreads = 1024;
constexpr int kLineStages = 6;     // a block's 5 (BLOCK_MAX_STAGES) + 1
constexpr int kBlockSmem = 231424; // 226 KiB (ops/dc_kernel.py::BLOCK_SMEM)
constexpr int kColTile = 4;        // columns a column tile (COL_TILE)
constexpr int kMaxTile = 4;        // lines a tile (rows: 1, 2 or 4)
constexpr int kClusterMax = 8;     // blocks a cluster (CLUSTER_MAX)

// The plan of a line in one launch: its length N, C blocks (1: a block),
// the radices of the in-place transform.
struct LinePlan {
  int len, clusters, stages;
  int radix[kLineStages];
};

// A tile's padded address: a padding entry per 16 (shared-memory banks).
__host__ __device__ __forceinline__ int tile_addr(int u) {
  return u + (u >> 4);
}

// Shared memory (float2 entries) of a tile of 1 << lg lines of `chunk`
// positions and the staging of `staged` raw points a line (rows: an odd
// line stride).
__host__ __device__ inline int line_smem(int chunk, int lg, int staged,
                                         bool rows) {
  const int u = chunk << lg;
  return tile_addr(u) + ((rows ? staged | 1 : staged) << lg);
}

struct LineArgs {
  const float2* in;
  float2* out;          // may be `in` (pass 2): a tile is read before written
  const float2* k0;     // pass 2; null: zero (K1-bwd)
  const float* mask;    // pass 2
  Lines ln;
  int n;                // raw points a line
  int inverse;          // passes 1 and 3: the inverse DFT
  const float2* chirp;  // CHIRP: c_j, n entries
  const float2* filt;   // CHIRP: F at the positions of its frequencies
  const float2* roots;  // the N roots, device memory
  const int* pos;       // split: the position of each frequency
  float scale;          // 1 / sqrt(n)
  int lg;               // log2 of the lines a tile
  int nc;               // raw points a block stages: ceil(n / C)
  int sline, spoint;    // staging strides of a line and of a point
  int dc;               // pass 2
};

// The odd R-point DFT of odd_dft (the same arithmetic), each result handed
// to emit(k, y_k) as soon as it is computed: the results never all sit in
// registers at once beside the sums a_j, b_j.
template <int R, bool INV, class Emit>
__device__ __forceinline__ void odd_dft_emit(const float2 (&v)[R],
                                             Emit emit) {
  constexpr int H = (R - 1) / 2;
  float2 a[H], b[H];
  float2 y0 = v[0];
#pragma unroll
  for (int j = 1; j <= H; ++j) {
    a[j - 1] = make_float2(v[j].x + v[R - j].x, v[j].y + v[R - j].y);
    b[j - 1] = make_float2(v[j].x - v[R - j].x, v[j].y - v[R - j].y);
    y0 = make_float2(y0.x + a[j - 1].x, y0.y + a[j - 1].y);
  }
#pragma unroll
  for (int k = 1; k <= H; ++k) {
    float2 c = v[0];
    float2 t = make_float2(0.f, 0.f);
#pragma unroll
    for (int j = 1; j <= H; ++j) {
      const int m = j * k % R;
      if (m == 0) {   // R = 9 or 15: cos 1, sin 0
        c = make_float2(c.x + a[j - 1].x, c.y + a[j - 1].y);
        continue;
      }
      const float2 w = odd_root(R, m <= H ? m : R - m);
      const float sn = m <= H ? w.y : -w.y;
      c = make_float2(fmaf(a[j - 1].x, w.x, c.x), fmaf(a[j - 1].y, w.x, c.y));
      t = make_float2(fmaf(b[j - 1].x, sn, t.x), fmaf(b[j - 1].y, sn, t.y));
    }
    const float2 minus = make_float2(c.x + t.y, c.y - t.x);
    const float2 plus = make_float2(c.x - t.y, c.y + t.x);
    emit(k, INV ? plus : minus);
    emit(R - k, INV ? minus : plus);
  }
  emit(0, y0);
}

// One stage's butterflies of radix R, from i = threadIdx.x in steps of
// blockDim.x: line l = i mod tl, then butterfly j = j0 + (i / tl) mod mloc
// of block blk = (i / tl) / mloc (blocks of L positions), positions p0 + q M
// (p0 = blk L + j). DIF: the R-point DFT, then the twiddles W_L^(jk) (root
// j k tws of the table); DIT: its adjoint, the conjugate twiddles, then the
// inverse R-point DFT. ld(p, l) and st(p, l, v) read and write a point.
// A DIF result's twiddle would be loaded after the store of the one
// before, which the compiler cannot move a load past: the butterfly loads
// W^1 to W^4 beside its points instead and forms W^(4a + b) = (W^4)^a W^b,
// one load latency a butterfly (4099^2 on a cluster 6.25 -> 5.05 ms, 2048^2
// 0.265 -> 0.251, the block chirp within 5%; timed in turns on the card).
template <int R, bool DIT, class Ld, class St>
__device__ __forceinline__ void line_stage(int count, int lg, int mloc,
                                           int j0, int L, int M, int tws,
                                           const float2* roots, Ld ld,
                                           St st) {
  // t / mloc as a multiply-high by ceil(2^32 / mloc): exact while
  // t mloc < 2^32 (t < 2^16, mloc <= kBlockLine)
  const unsigned inv = mloc > 1 ? 0xffffffffu / (unsigned)mloc + 1u : 0u;
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    const int l = i & ((1 << lg) - 1), t = i >> lg;
    const int blk = mloc > 1 ? (int)__umulhi((unsigned)t, inv) : t;
    const int j = j0 + t - blk * mloc;
    const int p0 = blk * L + j;
    const bool tw = M > 1 && j > 0;
    float2 v[R];
#pragma unroll
    for (int q = 0; q < R; ++q) v[q] = ld(p0 + q * M, l);
    if (DIT && tw) {
#pragma unroll
      for (int k = 1; k < R; ++k) v[k] = cmulc(v[k], roots[j * k * tws]);
    }
    float2 w4[4];
    if (!DIT && tw) {
#pragma unroll
      for (int b = 1; b <= 4; ++b)
        if (b < R) w4[b & 3] = roots[j * b * tws];
    }
    auto emit = [&](int k, float2 y) {
      if (!DIT && tw && k) {
        float2 w = k & 3 ? w4[k & 3] : make_float2(1.f, 0.f);
        for (int a = 0; a < (k >> 2); ++a) w = cmul(w, w4[0]);
        y = cmul(y, w);
      }
      st(p0 + k * M, l, y);
    };
    if constexpr (R & 1) {
      odd_dft_emit<R, DIT>(v, emit);
    } else {
      dft<R, DIT>(v, 0);
#pragma unroll
      for (int k = 0; k < R; ++k) emit(k, v[k]);
    }
  }
}

template <bool DIT, class Ld, class St>
__device__ __forceinline__ void line_stage_r(int r, int count, int lg,
                                             int mloc, int j0, int L, int M,
                                             int tws, const float2* roots,
                                             Ld ld, St st) {
  switch (r) {
#define CSMRI_LINE(R)                                                      \
    case R:                                                                \
      line_stage<R, DIT>(count, lg, mloc, j0, L, M, tws, roots, ld, st); \
      break;
    CSMRI_LINE(2) CSMRI_LINE(3) CSMRI_LINE(4) CSMRI_LINE(5) CSMRI_LINE(7)
    CSMRI_LINE(8) CSMRI_LINE(9) CSMRI_LINE(11) CSMRI_LINE(13)
    CSMRI_LINE(15) CSMRI_LINE(16)
#undef CSMRI_LINE
  }
}

// Threads a tile takes: 1024 above 12288 points (a column tile of 4116,
// one block an SM), 512 above 4096, else 256 (timed in turns on the card:
// a 1031-row column tile of 8316 points is faster on 512, 2053's of 16464
// on 1024).
__host__ __device__ inline int line_threads(int points) {
  const int t = points > 12288 ? 1024 : points > 4096 ? 512 : 256;
  return t < kLineThreads ? t : kLineThreads;
}

// A pass of the chirp or split route (a.dc: pass 2, the DFT along H, the
// merge and the inverse DFT along H; else the DFT, or with a.inverse the
// inverse DFT, of each line), each times a.scale, on one block a tile
// (CLUSTER false) or a cluster of p.clusters blocks a tile.
template <bool CHIRP, bool CLUSTER>
__device__ __forceinline__ void lines_body(const LineArgs& a,
                                           const LinePlan& p) {
  __shared__ LinePlan sp;
  __shared__ long base[2][kMaxTile];
  __shared__ float2* rbuf[kClusterMax];
  __shared__ float2* rstg[kClusterMax];
  extern __shared__ __align__(16) float2 smem[];
  namespace cg = cooperative_groups;
  // twiddles preloaded (line_stage) where the tables sit in device memory;
  // there the chirp's filter rides on the loads of the first stage of
  // decimation in time, else on the stores of the last of decimation in
  // frequency
  const int C = CLUSTER ? p.clusters : 1;
  const int rank = CLUSTER ? (int)cg::this_cluster().block_rank() : 0;
  const int N = p.len, chunk = N / C, lg = a.lg, tl = 1 << lg, n = a.n;
  const int nc = a.nc;
  const bool dc = a.dc, rows = a.ln.ps == 1;
  float2* buf = smem;
  float2* stg = smem + tile_addr(chunk << lg);
  // the tables, read through L1 (copies in shared memory were no faster)
  const float2* roots = a.roots;
  const float2* chirp = a.chirp;
  const float2* filt_tab = a.filt;
  const int* pos = a.pos;
  if (threadIdx.x == 0) sp = p;
  if constexpr (CLUSTER) {
    if (threadIdx.x < C) {
      rbuf[threadIdx.x] = cg::this_cluster().map_shared_rank(buf,
                                                             threadIdx.x);
      rstg[threadIdx.x] = cg::this_cluster().map_shared_rank(stg,
                                                             threadIdx.x);
    }
  }
  auto sync = [&]() {
    if constexpr (CLUSTER)
      cg::this_cluster().sync();
    else
      __syncthreads();
  };
  const long tiles = (a.ln.count + tl - 1) / tl;
  const long step = CLUSTER ? gridDim.x / C : gridDim.x;
  auto lines_of = [&](long tile) {
    const long left = a.ln.count - tile * tl;
    return left < tl ? (int)left : tl;
  };
  auto set_base = [&](long tile, int slot) {
    const int x = threadIdx.x;
    if (x < tl) {
      const int lines = lines_of(tile);
      base[slot][x] = a.ln.base(tile * tl + (x < lines ? x : lines - 1));
    }
  };
  // cp.async of a tile's raw points e of this block's share into staging
  auto stage = [&](long tile, int slot) {
    const int e0 = rank * nc;
    const int ec = n - e0 < nc ? n - e0 : nc;
    const int lines = lines_of(tile);
    if (ec <= 0) return;
    if (rows) {
      for (int i = threadIdx.x; i < lines * ec; i += blockDim.x) {
        const int l = i / ec, e = i - l * ec;
        cp_async8(stg + l * a.sline + e, a.in + base[slot][l] + e0 + e);
      }
    } else {
      for (int i = threadIdx.x; i < (ec << lg); i += blockDim.x) {
        const int l = i & (tl - 1), e = i >> lg;
        if (l < lines)
          cp_async8(stg + (e << lg) + l,
                    a.in + base[slot][l] + (long)(e0 + e) * a.ln.ps);
      }
    }
  };
  // point p (of the whole line) of line l, in whichever block holds it
  auto at = [&](int pp, int l) -> float2* {
    if constexpr (CLUSTER) {
      const int r = pp / chunk;
      return rbuf[r] + tile_addr(((pp - r * chunk) << lg) | l);
    } else {
      return buf + tile_addr((pp << lg) | l);
    }
  };
  auto mine = [&](int pp, int l) -> float2& {
    return buf[tile_addr((pp << lg) | l)];
  };
  auto staged = [&](int e, int l) -> float2 {
    const float2* s = stg;
    if constexpr (CLUSTER) {
      const int r = e / nc;
      s = rstg[r];
      e -= r * nc;
    }
    return s[e * a.spoint + l * a.sline];
  };
  const int S = p.stages;
  const int off = rank * chunk;   // this block's first position
  // The first stage of decimation in frequency over the whole line (j
  // shared out over the cluster's blocks): the raw points from the
  // staging (chirped, the inverse's conjugated), or with `from_buf` the
  // points below n from the buffer; zeros above n.
  bool from_buf = false;
  auto first_ld = [&](int pp, int l) {
    if (pp >= n) return make_float2(0.f, 0.f);
    if (from_buf) return *at(pp, l);
    float2 v = staged(pp, l);
    if (a.inverse) v = conj2(v);
    return CHIRP ? cmulc(v, chirp[pp]) : v;
  };
  auto set_at = [&](int pp, int l, float2 v) { *at(pp, l) = v; };
  auto first_stage = [&]() {
    const int r = sp.radix[0], M = N / r;
    const int share = (M + C - 1) / C, j0 = rank * share;
    const int mloc = M - j0 < share ? M - j0 : share;
    if (mloc > 0)
      line_stage_r<false>(r, mloc << lg, lg, mloc, j0, N, M, 1, roots,
                          first_ld, set_at);
  };
  // The later stages on this block's share; with `filt` set (the chirp's
  // first stage of decimation in time) the points read times the filter,
  // loaded before the butterfly's stores
  const float2* filt = nullptr;
  auto get_mine = [&](int pp, int l) {
    const float2 v = mine(pp, l);
    return filt ? cmul(v, filt[off + pp]) : v;
  };
  auto set_mine = [&](int pp, int l, float2 v) { mine(pp, l) = v; };
  auto dif_rest = [&]() {
    int L = N / sp.radix[0];
    for (int s = 1; s < S; ++s) {
      const int r = sp.radix[s], M = L / r;
      line_stage_r<false>(r, (chunk / r) << lg, lg, M, 0, L, M, N / L,
                          roots, get_mine, set_mine);
      __syncthreads();
      L = M;
    }
    filt = nullptr;
  };
  // Decimation in time on this block's share, stages S - 1 to 1
  auto dit_rest = [&]() {
    int L = sp.radix[S - 1];
    for (int s = S - 1; s >= 1; --s) {
      const int r = sp.radix[s], M = L / r;
      filt = CHIRP && s == S - 1 ? filt_tab : nullptr;
      line_stage_r<true>(r, (chunk / r) << lg, lg, M, 0, L, M, N / L, roots,
                         get_mine, set_mine);
      filt = nullptr;
      L *= sp.radix[s - 1];
      if (s > 1) __syncthreads();
    }
  };
  // The last stage of decimation in time over the whole line, its natural-
  // order results below n handed on: kOutMerge the chirp's DFT along H
  // merged and turned into the inverse DFT's input, back into the buffer;
  // else (times the chirp's way out, conjugated for an inverse) to device
  // memory.
  enum { kOutStore = 0, kOutMerge = 1 };
  int out_mode = kOutStore;
  bool conj_out = false;
  int lines = 0;
  const long* bs = base[0];
  auto get_at = [&](int pp, int l) { return *at(pp, l); };
  auto last_st = [&](int pp, int l, float2 v) {
    if (pp >= n || l >= lines) return;
    const long g = bs[l] + (long)pp * a.ln.ps;
    if (CHIRP) v = cmulc(v, chirp[pp]);
    if (out_mode == kOutMerge) {
      const float keep = 1.f - __ldg(a.mask + g);
      const float2 kk = a.k0 ? __ldg(a.k0 + g) : make_float2(0.f, 0.f);
      const float2 k = make_float2(fmaf(keep, v.x * a.scale, kk.x),
                                   fmaf(keep, v.y * a.scale, kk.y));
      *at(pp, l) = cmulc(conj2(k), chirp[pp]);
      return;
    }
    if (conj_out) v = conj2(v);
    a.out[g] = make_float2(v.x * a.scale, v.y * a.scale);
  };
  auto last_stage = [&]() {
    const int r = sp.radix[0], M = N / r;
    const int share = (M + C - 1) / C, j0 = rank * share;
    const int mloc = M - j0 < share ? M - j0 : share;
    if (mloc > 0)
      line_stage_r<true>(r, mloc << lg, lg, mloc, j0, N, M, 1, roots, get_at,
                         last_st);
  };

  long tile = CLUSTER ? blockIdx.x / C : blockIdx.x;
  int slot = 0;
  if (tile < tiles) set_base(tile, 0);
  sync();
  if (tile < tiles) stage(tile, 0);
  cp_async_commit();
  for (; tile < tiles; tile += step, slot ^= 1) {
    const long next = tile + step;
    lines = lines_of(tile);
    bs = base[slot];
    cp_async_wait0();
    sync();   // the staging everywhere; the last tile's reads done
    if (next < tiles) set_base(next, slot ^ 1);
    from_buf = false;
    first_stage();
    sync();   // every share's points; the staging read
    if (next < tiles) stage(next, slot ^ 1);
    cp_async_commit();
    if constexpr (CHIRP) {
      dif_rest();
      dit_rest();
      sync();
      if (dc) {
        out_mode = kOutMerge;
        last_stage();
        sync();
        from_buf = true;
        first_stage();
        sync();
        dif_rest();
        dit_rest();
        sync();
      }
      out_mode = kOutStore;
      conj_out = dc || a.inverse;
      last_stage();
    } else {
      dif_rest();
      sync();   // the frequencies at their positions, in every share
      // this block's share of the frequencies k, at line_positions
      if (dc) {
        for (int i = threadIdx.x; i < (chunk << lg); i += blockDim.x) {
          const int l = i & (tl - 1), k = off + (i >> lg);
          if (l >= lines) continue;
          float2* f = at(pos[k], l);
          const long g = bs[l] + (long)k * a.ln.ps;
          const float keep = 1.f - __ldg(a.mask + g);
          const float2 kk = a.k0 ? __ldg(a.k0 + g) : make_float2(0.f, 0.f);
          const float2 v = *f;
          *f = make_float2(fmaf(keep, v.x * a.scale, kk.x),
                           fmaf(keep, v.y * a.scale, kk.y));
        }
        sync();
        dit_rest();
        sync();
        out_mode = kOutStore;
        conj_out = false;
        last_stage();
      } else {
        for (int i = threadIdx.x; i < (chunk << lg); i += blockDim.x) {
          int l, k;
          if (rows) {
            l = i / chunk;
            k = i - l * chunk;
          } else {
            l = i & (tl - 1);
            k = i >> lg;
          }
          if (l >= lines) continue;
          float2 v = *at(pos[off + k], l);
          if (a.inverse) v = conj2(v);
          a.out[bs[l] + (long)(off + k) * a.ln.ps] =
              make_float2(v.x * a.scale, v.y * a.scale);
        }
      }
    }
  }
  // no block leaves while another may read its shared memory
  sync();
}

template <bool CHIRP>
__global__ void __launch_bounds__(kLineThreads, 1)
block_lines(LineArgs a, LinePlan p) {
  lines_body<CHIRP, false>(a, p);
}

template <bool CHIRP>
__global__ void __launch_bounds__(kLineThreads, 1)
cluster_lines(LineArgs a, LinePlan p) {
  lines_body<CHIRP, true>(a, p);
}

// --- device stages (lines longer than a cluster holds) ---
//
// A transform of N = R_0 R_1 ... R_(S-1) points (S >= 2; each R_s at most
// kStageLine with a mixed-radix plan; ops/dc_kernel.py::split_radices) is
// S launches of stage_lines, one Stockham stage each at device level:
// butterfly j < N / R of a line reads points j + q N / R (q < R),
// twiddles them by exp(-+2 pi i k q / (Ns R)) (k = j mod Ns, Ns = R_0 ...
// R_(s-1); host table [q Ns + k]), runs the R-point DFT in the block
// (mix_fft on a tile of butterflies in the mixed-radix layout) and writes
// point q to (j - k) R + k + q Ns, between device buffers. The last stage
// leaves a line in natural order, so every pass keeps its layout, k0 and
// the mask are read at their own positions and a spatial rank's column
// block is any block. A tile's butterflies are neighbours in memory
// (points j of one row, or the same j of neighbouring columns), so loads
// and stores coalesce; the first stage of a row writes whole runs of R
// points. The pointwise steps ride on a stage: the chirp's way in on the
// first; the filter, the chirp's way out, the merge and the scale on the
// last. What bounds it: bytes, 16 B a point a stage through device memory.

constexpr int kMaxTileLines = 16;

// Butterflies a tile (log2) of a stage of radix r: 16 up to 128 (a tile's
// loads and stores are 128-byte runs), then fewer, so that a tile's two
// buffers stay under 65 KB. A radix's twiddles stay in device memory,
// read through L1.
int stage_tile_lg(int r) {
  return r <= 128 ? 4 : r <= 512 ? 3 : r <= 1024 ? 2 : r <= 2048 ? 1 : 0;
}

// A tile's stride between a line's points: odd, so that staging a row's
// neighbouring points hits every bank; one line needs none.
__host__ __device__ inline int tile_stride(int lg) {
  return lg ? (1 << lg) + 1 : 1;
}

// Element i of a tile of 1 << lg lines of `len` points: points fastest
// (rows in memory), or lines fastest.
__device__ __forceinline__ void tile_at(int i, bool points, int lg, int len,
                                        int* l, int* e) {
  if (points) {
    *l = i / len;
    *e = i - *l * len;
  } else {
    *l = i & ((1 << lg) - 1);
    *e = i >> lg;
  }
}

enum StageIn { kIn = 0, kInChirp = 1 };
enum StageOut { kOut = 0, kOutFilter = 1, kOutChirp = 2, kOutMerge = 4 };

struct StageArgs {
  const float2* src;
  float2* dst;
  Lines in, out;          // the same lines, each with its own strides
  int n_in, n_out;        // points a line reads (zeros above) and writes
  int len, span;          // N and this stage's Ns
  const float2* dtw;      // this stage's twiddles, [q * Ns + k], Ns > 1
  const float2* chirp;    // kInChirp, kOutChirp
  const float2* filt;     // kOutFilter
  const float2* k0;       // kOutMerge; null: zero (K1-bwd)
  const float* mask;      // kOutMerge, at dst's positions
  float scale;
  int pre, post, conj_in, conj_out;
};

template <bool INV>
__global__ void __launch_bounds__(kMixThreads)
stage_lines(StageArgs a, MixPlan p, const float2* __restrict__ tw_g, int lg) {
  __shared__ MixPlan sp;
  __shared__ long src0[kMaxTileLines], dst0[kMaxTileLines];
  __shared__ int pos0[kMaxTileLines], dpos0[kMaxTileLines], kq[kMaxTileLines];
  extern __shared__ __align__(16) float2 smem[];
  const int r = p.n, tl = 1 << lg, cs = tile_stride(lg), elems = r * cs;
  const int fly = a.len / r;   // butterflies a line
  float2* buf0 = smem;
  float2* buf1 = smem + elems;
  if (threadIdx.x == 0) sp = p;
  const long total = a.in.count * fly;
  const long tiles = (total + tl - 1) / tl;
  const bool runs = a.out.lpg == 1 && a.out.ps == 1 && a.span == 1;
  const int lpg = a.in.lpg;
  for (long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long t0 = tile * tl;
    const int lines = total - t0 < tl ? (int)(total - t0) : tl;
    const int x = threadIdx.x;
    if (x < tl) {   // butterfly x of the tile: point j of its line
      const long b = t0 + (x < lines ? x : 0);
      const long t = b / lpg;
      const int j = (int)(t % fly);
      const long line = (t / fly) * lpg + b % lpg;
      const int k = j % a.span;
      src0[x] = a.in.base(line);
      dst0[x] = a.out.base(line);
      pos0[x] = j;
      kq[x] = k;
      dpos0[x] = (j - k) * r + k;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < tl * r; i += blockDim.x) {
      const int l = i & (tl - 1), q = i >> lg;
      const int pos = pos0[l] + q * fly;
      float2 v = make_float2(0.f, 0.f);
      if (l < lines && pos < a.n_in) {
        v = a.src[src0[l] + (long)pos * a.in.ps];
        if (a.pre == kInChirp)
          v = cmulc(a.conj_in ? conj2(v) : v, __ldg(a.chirp + pos));
        if (a.span > 1) {
          const float2 w = __ldg(a.dtw + q * a.span + kq[l]);
          v = INV ? cmulc(v, w) : cmul(v, w);
        }
      }
      buf0[q * cs + l] = v;
    }
    __syncthreads();
    const float2* f = mix_fft<INV>(buf0, buf1, sp, tw_g, lg, cs);
    for (int i = threadIdx.x; i < tl * r; i += blockDim.x) {
      int l, q;
      tile_at(i, runs, lg, r, &l, &q);
      const int d = dpos0[l] + q * a.span;
      if (l >= lines || d >= a.n_out) continue;
      float2 v = f[q * cs + l];
      if (a.post & kOutFilter) v = cmul(v, __ldg(a.filt + d));
      if (a.post & kOutChirp) {
        v = cmulc(v, __ldg(a.chirp + d));
        if (a.conj_out) v = conj2(v);
      }
      const long g = dst0[l] + (long)d * a.out.ps;
      if (a.post & kOutMerge) {
        const float keep = 1.f - __ldg(a.mask + g);
        const float2 kk = a.k0 ? __ldg(a.k0 + g) : make_float2(0.f, 0.f);
        v = make_float2(fmaf(keep, v.x * a.scale, kk.x),
                        fmaf(keep, v.y * a.scale, kk.y));
      } else {
        v = make_float2(v.x * a.scale, v.y * a.scale);
      }
      a.dst[g] = v;
    }
    __syncthreads();
  }
}

float ortho(int n) { return (float)(1.0 / sqrt((double)n)); }

// --- one route per axis ---

// ops/dc_kernel.py::_ROUTE_CODES
enum Route { kRadix = 0, kMixed = 1, kDense = 2, kChirp = 3, kSplit = 4 };

bool aligned16(const void* a, const void* b, const void* c = nullptr) {
  return ((uintptr_t)a | (uintptr_t)b | (uintptr_t)c) % 16 == 0;
}

// --- the chirp and split routes' launches ---

constexpr int kMaxDeviceStages = 8;

// An axis on the chirp or split route (ops/dc_kernel.py::_plan_args,
// axis_tables): its side n, the transform's length len (the chirp's m, or
// n). In one launch a pass (stages 1): its LinePlan and its tables: the
// chirp at 0, the filter at n and the roots at n + len (chirp route), or
// the roots at 0 and the positions of
// the frequencies at len, as int32 (split route). On device stages
// (stages >= 2): each stage's in-block plan and span, and the offsets of
// its tables: the chirp at 0 and the filter at n (chirp route), then each
// stage's in-block twiddles, then the device twiddles of stages 1...
struct AxisPlan {
  bool chirp;
  int n, len, stages;
  LinePlan line;
  long roots, pos;
  MixPlan block[kMaxDeviceStages];
  int span[kMaxDeviceStages];
  long tw_block[kMaxDeviceStages], tw_dev[kMaxDeviceStages];
};

// Decode and check a line plan: [1, C, S, R_0, ..., R_(S-1)]: 2 to
// kLineStages radices of the set, product len; C a divisor of the first
// radix (1: a block) up to kClusterMax, len / C at most kBlockLine; a
// column tile and its staging within kBlockSmem.
bool line_plan(const unsigned long long* codes, AxisPlan* ap) {
  LinePlan& p = ap->line;
  const unsigned long long c = codes[1], stages = codes[2];
  if (c < 1 || c > kClusterMax || stages < 2 || stages > kLineStages)
    return false;
  p.len = ap->len;
  p.clusters = (int)c;
  p.stages = (int)stages;
  long prod = 1;
  for (int s = 0; s < p.stages; ++s) {
    const unsigned long long r = codes[3 + s];
    if (r > 16 || !mix_radix((int)r)) return false;
    p.radix[s] = (int)r;
    prod *= (long)r;
    if (prod > ap->len) return false;
  }
  if (prod != ap->len || p.radix[0] % p.clusters || ap->len % p.clusters)
    return false;
  const int chunk = ap->len / p.clusters;
  const int staged = (ap->n + p.clusters - 1) / p.clusters;
  if (chunk > kBlockLine ||
      line_smem(chunk, 2, staged, false) * 8 > kBlockSmem)
    return false;
  ap->roots = ap->chirp ? ap->n + (long)ap->len : 0;
  ap->pos = ap->len;
  return true;
}

// Decode and check an axis's plan: len is m >= 2n - 1 on the chirp route,
// n on the split route; codes[0] is 1 (one launch a pass: line_plan) or
// the number S >= 2 of device stages, [S, R_0, plan code of R_0, ...],
// each a mixed-radix plan of its radix, their product len.
bool axis_plan(int route, int n, unsigned long long len,
               const unsigned long long* codes, AxisPlan* ap) {
  ap->chirp = route == kChirp;
  if (codes == nullptr || n < 2 || len > (1ull << 30) ||
      (ap->chirp ? len < 2ull * n - 1 : len != (unsigned long long)n))
    return false;
  const unsigned long long stages = codes[0];
  if (stages < 1 || stages > kMaxDeviceStages) return false;
  ap->n = n;
  ap->len = (int)len;
  ap->stages = (int)stages;
  if (stages == 1) return line_plan(codes, ap);
  long off = ap->chirp ? n + (long)len : 0;
  unsigned long long prod = 1;
  for (int s = 0; s < ap->stages; ++s) {
    const unsigned long long r = codes[1 + 2 * s];
    if (r < 2 || r > kStageLine ||
        !mix_plan((int)r, codes[2 + 2 * s], &ap->block[s]))
      return false;
    ap->span[s] = (int)prod;
    prod *= r;
    if (prod > len) return false;
    ap->tw_block[s] = off;
    off += ap->block[s].tw_size;
  }
  if (prod != len) return false;
  ap->tw_dev[0] = 0;
  for (int s = 1; s < ap->stages; ++s) {
    ap->tw_dev[s] = off;
    off += (long)ap->span[s] * ap->block[s].n;
  }
  return true;
}

template <bool CHIRP>
int line_launch(const LineArgs& a, const LinePlan& p, int threads, int smem,
                long tiles, cudaStream_t st) {
  if (p.clusters == 1) {
    auto kern = block_lines<CHIRP>;
    unsigned grid = 0;
    const int err = walk_grid(kern, threads, smem, tiles, &grid);
    if (err) return err;
    kern<<<grid, threads, smem, st>>>(a, p);
    return (int)cudaGetLastError();
  }
  auto kern = cluster_lines<CHIRP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.clusters;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // as many clusters as fit on the card at once, at most one per tile
  cfg.gridDim = dim3(p.clusters * (unsigned)(tiles < 65535 ? tiles : 65535));
  int fit = 0;
  err = cudaOccupancyMaxActiveClusters(&fit, kern, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (fit < 1) return (int)cudaErrorInvalidConfiguration;
  cfg.gridDim = dim3(p.clusters * (unsigned)(tiles < fit ? tiles : fit));
  err = cudaLaunchKernelEx(&cfg, kern, a, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// A pass of lines one launch holds (block_lines, cluster_lines): the DFT of
// each line (inverse: the inverse DFT) or with `dc` the column pass, times
// `scale`. Rows take tiles of 4, 2 or 1 lines (at most 2048 points a
// block, and down to one line while the pass has fewer tiles than SMs);
// columns kColTile.
int line_pass(const AxisPlan& ap, bool dc, bool inverse, const float2* in,
              float2* out, const float2* k0, const float* mask, Lines ln,
              const float2* tabs, float scale, cudaStream_t st) {
  const LinePlan& p = ap.line;
  const int c = p.clusters, chunk = ap.len / c;
  const int nc = (ap.n + c - 1) / c;
  const bool rows = ln.ps == 1;
  int lg = 2;
  if (rows) {
    while (lg > 0 && (chunk << lg > 2048 || (ln.count >> lg) < sm_count() ||
                      line_smem(chunk, lg, nc, true) * 8 > kBlockSmem))
      --lg;
  }
  LineArgs a = {};
  a.in = in;
  a.out = out;
  a.k0 = k0;
  a.mask = mask;
  a.ln = ln;
  a.n = ap.n;
  a.inverse = inverse;
  a.chirp = tabs;
  a.filt = tabs + ap.n;
  a.roots = tabs + ap.roots;
  a.pos = reinterpret_cast<const int*>(tabs + ap.pos);
  a.scale = scale;
  a.lg = lg;
  a.nc = nc;
  a.sline = rows ? nc | 1 : 1;
  a.spoint = rows ? 1 : 1 << lg;
  a.dc = dc;
  const int threads = line_threads(chunk << lg);
  const int smem = line_smem(chunk, lg, nc, rows) * 8;
  const long tiles = (ln.count + (1 << lg) - 1) >> lg;
  return ap.chirp ? line_launch<true>(a, p, threads, smem, tiles, st)
                  : line_launch<false>(a, p, threads, smem, tiles, st);
}

// Stage s of the axis (the inverse transform's with `inv`) on a's lines.
int stage_launch(const AxisPlan& ap, int s, bool inv, StageArgs a,
                 const float2* tabs, cudaStream_t st) {
  const MixPlan& p = ap.block[s];
  const int lg = stage_tile_lg(p.n), tl = 1 << lg;
  const int smem = 2 * p.n * tile_stride(lg) * 8;
  a.len = ap.len;
  a.span = ap.span[s];
  a.dtw = s ? tabs + ap.tw_dev[s] : nullptr;
  void (*kern)(StageArgs, MixPlan, const float2*, int) =
      inv ? stage_lines<true> : stage_lines<false>;
  unsigned grid = 0;
  const int err = walk_grid(
      kern, kMixThreads, smem,
      (a.in.count * (ap.len / p.n) + tl - 1) / tl, &grid);
  if (err) return err;
  kern<<<grid, kMixThreads, smem, st>>>(a, p, tabs + ap.tw_block[s], lg);
  return (int)cudaGetLastError();
}

// The DFT (the inverse with `inverse`) of every line of src (layout `in`,
// n points) into dst (layout `out`) on the device stages, through the work
// buffers w0 and w1 in turn (layout `work`, len points a line): S launches
// on the split route; on the chirp route 2S, the convolution's forward
// and inverse transforms. The last launch stores times `scale`, or with
// `merge` merges with k0 and the mask at dst's positions.
int stage_dft(const AxisPlan& ap, const float2* tabs, const float2* src,
              float2* dst, Lines in, Lines out, Lines work, float2* w0,
              float2* w1, bool inverse, bool merge, const float2* k0,
              const float* mask, float scale, cudaStream_t st) {
  const int count = ap.chirp ? 2 * ap.stages : ap.stages;
  for (int i = 0; i < count; ++i) {
    const bool first = i == 0, last = i == count - 1;
    StageArgs a = {};
    a.src = first ? src : (i - 1) % 2 ? w1 : w0;
    a.dst = last ? dst : i % 2 ? w1 : w0;
    a.in = first ? in : work;
    a.out = last ? out : work;
    a.n_in = first ? ap.n : ap.len;
    a.n_out = last ? ap.n : ap.len;
    a.chirp = tabs;
    a.filt = tabs + ap.n;
    a.k0 = k0;
    a.mask = mask;
    a.scale = 1.f;
    bool inv = inverse;
    if (ap.chirp) {
      inv = i >= ap.stages;
      if (first) {
        a.pre = kInChirp;
        a.conj_in = inverse;
      }
      if (i == ap.stages - 1) a.post = kOutFilter;
      if (last) {
        a.post = kOutChirp;
        a.conj_out = inverse;
      }
    }
    if (last) {
      a.post |= merge ? kOutMerge : kOut;
      a.scale = scale;
    }
    const int err = stage_launch(ap, i % ap.stages, inv, a, tabs, st);
    if (err) return err;
  }
  return 0;
}

// Passes 1 and 3 on the chirp and split routes: `rows` lines of n points.
int lines_rows(const AxisPlan& ap, const float2* in, float2* out,
               float2* work, long rows, const float2* tabs, bool inverse,
               cudaStream_t st) {
  const float scale = ortho(ap.n);
  const Lines ln = {rows, 1, ap.n, 1};
  if (ap.stages == 1)
    return line_pass(ap, false, inverse, in, out, nullptr, nullptr, ln, tabs,
                     scale, st);
  if (work == nullptr) return (int)cudaErrorInvalidValue;
  const Lines wl = {rows, 1, ap.len, 1};
  return stage_dft(ap, tabs, in, out, ln, ln, wl, work, work + rows * ap.len,
                   inverse, false, nullptr, nullptr, scale, st);
}

// Pass 2 on the chirp and split routes: (batch, h, w) column blocks.
int lines_cols(const AxisPlan& ap, const float2* in, float2* out,
               const float2* k0, const float* mask, float2* work, int batch,
               int h, int w, const float2* tabs, cudaStream_t st) {
  const float scale = ortho(h);
  const long lines = (long)batch * w;
  const Lines ln = {lines, w, (long)h * w, w};
  if (ap.stages == 1)
    return line_pass(ap, true, false, in, out, k0, mask, ln, tabs, scale, st);
  if (work == nullptr) return (int)cudaErrorInvalidValue;
  const Lines wl = {lines, w, (long)ap.len * w, w};
  float2* w1 = work + lines * ap.len;
  const int err = stage_dft(ap, tabs, in, out, ln, ln, wl, work, w1, false,
                            true, k0, mask, scale, st);
  if (err) return err;
  return stage_dft(ap, tabs, out, out, ln, ln, wl, work, w1, true, false,
                   nullptr, nullptr, scale, st);
}


// Passes 1 and 3 (`inverse`): `rows` lines of n points from in to out on
// `route` with its plan (and on the chirp and split routes its device
// stages and work buffer) and table, times 1 / sqrt(n).
int rows_launch(int route, unsigned long long plan,
                const unsigned long long* stages, const float2* in,
                float2* out, float2* work, long rows, int n,
                const float2* tw, bool inverse, cudaStream_t st) {
  if (rows < 1) return (int)cudaErrorInvalidValue;
  const float scale = ortho(n);
  if (route == kRadix) {
    if (!supported(n, (int)plan) || plan >> 31 || !aligned16(in, out))
      return (int)cudaErrorInvalidValue;
    return inverse ? rows_pass<true>(n, in, out, rows, tw, scale, st)
                   : rows_pass<false>(n, in, out, rows, tw, scale, st);
  }
  if (route == kMixed) {
    MixPlan p;
    if (n > kTileLine || !mix_plan(n, plan, &p))
      return (int)cudaErrorInvalidValue;
    return inverse ? mix_rows_pass<true>(in, out, rows, p, tw, scale, st)
                   : mix_rows_pass<false>(in, out, rows, p, tw, scale, st);
  }
  if (route == kDense && n >= 2 && n <= kTileLine)
    return inverse ? dft_rows_pass<true>(in, out, rows, n, tw, scale, st)
                   : dft_rows_pass<false>(in, out, rows, n, tw, scale, st);
  AxisPlan ap;
  if ((route == kChirp || route == kSplit) &&
      axis_plan(route, n, plan, stages, &ap))
    return lines_rows(ap, in, out, work, rows, tw, inverse, st);
  return (int)cudaErrorInvalidValue;
}

// Pass 2 on (batch, h, w) column blocks (row stride w) from in to out
// (distinct or the same buffer), k0 null for K1-bwd. The radix route
// takes w in whole strips of col_strip(h) columns, or one strip of a
// power of two below that; the others any w from 1 (partial strips).
int cols_launch(int route, unsigned long long plan,
                const unsigned long long* stages, const float2* in,
                float2* out, const float2* k0, const float* mask,
                float2* work, int batch, int h, int w, const float2* tw,
                cudaStream_t st) {
  if (batch < 1 || w < 1) return (int)cudaErrorInvalidValue;
  const float scale = ortho(h);
  if (route == kRadix) {
    const int strip = w < col_strip(h) ? w : col_strip(h);
    if (!supported(h, (int)plan) || plan >> 31 || w < 2 || w % strip ||
        (strip & (strip - 1)) || !aligned16(in, out, k0))
      return (int)cudaErrorInvalidValue;
    return cols_pass(h, in, out, k0, mask, batch, w, tw, scale, st);
  }
  if (route == kMixed) {
    MixPlan p;
    if (h > kTileLine || !mix_plan(h, plan, &p))
      return (int)cudaErrorInvalidValue;
    return mix_cols_pass(in, out, k0, mask, batch, w, p, tw, scale, st);
  }
  if (route == kDense && h >= 2 && h <= kTileLine)
    return dft_cols_pass(in, out, k0, mask, batch, h, w, tw, scale, st);
  AxisPlan ap;
  if ((route == kChirp || route == kSplit) &&
      axis_plan(route, h, plan, stages, &ap))
    return lines_cols(ap, in, out, k0, mask, work, batch, h, w, tw, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x, k0, y, scratch: (batch, h, w, 2) float32 (16-byte aligned where an
// axis takes the radix route); k0 may be null (zero); mask: (batch, h, w)
// float32. route_h, plan_h, stages_h, tw_h: H's route (0 radix, 1
// mixed-radix, 2 dense, 3 chirp, 4 split), its plan (one byte per stage's
// radix: FFT_PLANS or mixed_plan; unused by the dense route; the
// transform's length on the chirp and split routes), its device stages
// (null, or on the chirp and split routes a host array [S, R_0, plan of
// R_0, ...]: ops/dc_kernel.py::_plan_args) and its table
// (ops/dc_kernel.py::fft_tables, mixed_tables: stage s >= 1 at its offset,
// entry [q * Ns + m] = exp(-2 pi i m q / (Ns r)); dft_table: the h roots
// exp(-2 pi i m / h); axis_tables on the chirp and split routes); route_w,
// plan_w, stages_w, tw_w: W's. work: null, or where an axis runs on device
// stages two buffers of len points a line of the pass with the most
// (ops/dc_kernel.py::work_elems). Pass 1 and pass 3 run on W's route, pass
// 2 on H's, each the launches of dc_rows_pass / dc_cols_pass below.
// Launches on `stream`; returns a CUDA error code.
extern "C" int dc_forward(const void* x, const void* k0, const void* mask,
                          void* y, void* scratch, void* work,
                          const void* tw_h, const void* tw_w, int route_h,
                          unsigned long long plan_h, const void* stages_h,
                          int route_w, unsigned long long plan_w,
                          const void* stages_w, int batch, int h, int w,
                          void* stream) {
  if (batch < 1 || h < 2 || w < 2) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long rows = (long)batch * h;
  float2* t = (float2*)scratch;
  const auto* sw = (const unsigned long long*)stages_w;
  int err = rows_launch(route_w, plan_w, sw, (const float2*)x, t,
                        (float2*)work, rows, w, (const float2*)tw_w, false,
                        st);
  if (err) return err;
  err = cols_launch(route_h, plan_h, (const unsigned long long*)stages_h, t,
                    t, (const float2*)k0, (const float*)mask, (float2*)work,
                    batch, h, w, (const float2*)tw_h, st);
  if (err) return err;
  return rows_launch(route_w, plan_w, sw, t, (float2*)y, (float2*)work, rows,
                     w, (const float2*)tw_w, true, st);
}

// --- K1's passes one at a time: the DC distributed over a spatial group ---
//
// ops/dc_kernel.py::dc_distributed runs the DC of an image whose rows are
// split over S ranks: pass 1 on the rank's rows, an all-to-all that gives
// each rank all rows of its column block, pass 2 on those columns (with
// the rank's columns of k0 and the mask), the all-to-all back, pass 3.
// Each entry is the launch dc_forward makes for that pass, with the same
// route, plan, twiddles and scale, so a line's result is the same bits:
// the whole-image DC's rows, on every rank.
//
// The row passes (1, and 3 with `inverse`): `rows` lines of n points,
// (rows, n, 2) float32 from `in` to `out`; n is the image's width W,
// route, plan, stages and tw W's (dc_forward's route_w, plan_w, stages_w
// and tw_w); work as dc_forward's for these rows.
extern "C" int dc_rows_pass(const void* in, void* out, void* work,
                            const void* tw, int route,
                            unsigned long long plan, const void* stages,
                            int rows, int n, int inverse, void* stream) {
  return rows_launch(route, plan, (const unsigned long long*)stages,
                     (const float2*)in, (float2*)out, (float2*)work, rows, n,
                     (const float2*)tw, inverse != 0, (cudaStream_t)stream);
}

// The column pass: (batch, h, w, 2) float32 column blocks, all h rows of w
// columns (the row stride is w), from `in` to `out` (distinct or the same
// buffer); k0 (batch, h, w, 2) or null (zero: K1-bwd), mask (batch, h, w).
// route, plan, stages and tw are H's, the image's height; work as
// dc_forward's for these columns.
extern "C" int dc_cols_pass(const void* in, const void* k0, const void* mask,
                            void* out, void* work, const void* tw, int route,
                            unsigned long long plan, const void* stages,
                            int batch, int h, int w, void* stream) {
  return cols_launch(route, plan, (const unsigned long long*)stages,
                     (const float2*)in, (float2*)out, (const float2*)k0,
                     (const float*)mask, (float2*)work, batch, h, w,
                     (const float2*)tw, (cudaStream_t)stream);
}
