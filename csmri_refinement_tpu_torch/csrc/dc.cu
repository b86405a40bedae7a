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
// once: 28 B/pixel (20 without k0), against ~10 log2(HW) f32 flops/pixel for a radix-2
// FFT forward and back (~160 at 256^2: well under the card's f32 rate per
// byte of HBM traffic).
//
// Design. The TPU wrote the DFT as 16 split-real HxH matmuls only because
// it has no FFT unit. Here each 1D transform is a radix-2 decimation-in-
// time FFT in shared memory, in f32 FMA throughout (plain TF32 loses ~2e-2
// in k-space), with twiddles computed on the host in f64 and passed in.
// Three launches:
//   1. forward FFT along W, one block per few rows: x -> scratch;
//   2. forward FFT along H, the merge, inverse FFT along H, one block per
//      kCols adjacent columns of one image, in place in scratch: k-space
//      never makes an HBM round trip between the transform and its inverse;
//   3. inverse FFT along W: scratch -> y.
// That moves 60 B/pixel instead of the 28 B bound; folding the W passes
// into the column pass (whole images per block) is later work.
// Supported: H, W powers of two, 2 <= H <= 512, 2 <= W <= 2048.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowElems = 2048;  // complex values per block in the row passes
constexpr int kCols = 8;         // columns per block in the column pass
constexpr int kLogCols = 3;
constexpr int kMaxH = 512;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, -a.y * b.y), fmaf(a.x, b.y, a.y * b.x));
}

// In-place radix-2 DIT FFT of `lines` lines of length n = 2^logn held in
// shared memory; element j of line l sits at s[j * js + l * ls].
// tw[k] = exp(-2*pi*i*k/n) for k < n/2; the inverse uses its conjugate.
// LINE_FASTEST maps neighbouring threads to neighbouring lines (for the
// column layout, where lines are adjacent in memory); it needs `lines` to be
// 2^loglines.
template <bool INVERSE, bool LINE_FASTEST>
__device__ void fft_lines(float2* s, int n, int logn, int lines,
                          int loglines, int js, int ls,
                          const float2* __restrict__ tw) {
  const int total = n * lines;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    int l, j;
    if (LINE_FASTEST) {
      l = idx & (lines - 1);
      j = idx >> loglines;
    } else {
      l = idx >> logn;
      j = idx & (n - 1);
    }
    int r = (int)(__brev((unsigned)j) >> (32 - logn));
    if (j < r) {
      float2* a = s + j * js + l * ls;
      float2* b = s + r * js + l * ls;
      float2 t = *a;
      *a = *b;
      *b = t;
    }
  }
  __syncthreads();
  const int half_total = total >> 1;
  const int half_n = n >> 1;
  for (int st = 0; st < logn; ++st) {
    const int half = 1 << st;
    const int tw_stride = n >> (st + 1);
    for (int idx = threadIdx.x; idx < half_total; idx += blockDim.x) {
      int l, k;
      if (LINE_FASTEST) {
        l = idx & (lines - 1);
        k = idx >> loglines;
      } else {
        l = idx / half_n;
        k = idx - l * half_n;
      }
      const int pos = k & (half - 1);
      const int i0 = ((k >> st) << (st + 1)) + pos;
      float2 w = tw[pos * tw_stride];
      if (INVERSE) w.y = -w.y;
      float2* pa = s + i0 * js + l * ls;
      float2* pb = pa + half * js;
      const float2 a = *pa;
      const float2 b = cmul(*pb, w);
      *pa = make_float2(a.x + b.x, a.y + b.y);
      *pb = make_float2(a.x - b.x, a.y - b.y);
    }
    __syncthreads();
  }
}

// Passes 1 and 3: FFT along W of `rows` contiguous rows, times `scale`.
template <bool INVERSE>
__global__ void __launch_bounds__(kThreads)
row_fft(const float2* __restrict__ in, float2* __restrict__ out, long rows,
        int n, int logn, const float2* __restrict__ tw, float scale) {
  __shared__ float2 s[kRowElems];
  const int lines_per_block = kRowElems / n;
  const long row0 = (long)blockIdx.x * lines_per_block;
  const long left = rows - row0;
  const int lines = left < lines_per_block ? (int)left : lines_per_block;
  const int total = lines * n;
  const float2* src = in + row0 * n;
  for (int i = threadIdx.x; i < total; i += blockDim.x) s[i] = src[i];
  __syncthreads();
  fft_lines<INVERSE, false>(s, n, logn, lines, 0, 1, n, tw);
  float2* dst = out + row0 * n;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const float2 v = s[i];
    dst[i] = make_float2(v.x * scale, v.y * scale);
  }
}

// Pass 2: per kCols columns of one image, forward FFT along H, the merge
// (1 - m) * k + k0, inverse FFT along H; in place in t. HAS_K0 false: k0 is
// zero and not read.
template <bool HAS_K0>
__global__ void __launch_bounds__(kThreads)
col_dc(float2* __restrict__ t, const float2* __restrict__ k0,
       const float* __restrict__ mask, int h, int logh, int w,
       const float2* __restrict__ tw, float scale) {
  __shared__ float2 s[kMaxH * kCols];
  const int c0 = blockIdx.x * kCols;
  const int ncols = min(kCols, w - c0);
  const size_t img = (size_t)blockIdx.y * h * w;
  const int total = h * kCols;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int r = i >> kLogCols, c = i & (kCols - 1);
    s[i] = c < ncols ? t[img + (size_t)r * w + c0 + c] : make_float2(0.f, 0.f);
  }
  __syncthreads();
  fft_lines<false, true>(s, h, logh, kCols, kLogCols, kCols, 1, tw);
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int r = i >> kLogCols, c = i & (kCols - 1);
    if (c < ncols) {
      const size_t g = img + (size_t)r * w + c0 + c;
      const float keep = 1.f - mask[g];
      const float2 k = s[i];
      const float2 kk = HAS_K0 ? k0[g] : make_float2(0.f, 0.f);
      s[i] = make_float2(fmaf(keep, k.x * scale, kk.x),
                         fmaf(keep, k.y * scale, kk.y));
    }
  }
  __syncthreads();
  fft_lines<true, true>(s, h, logh, kCols, kLogCols, kCols, 1, tw);
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int r = i >> kLogCols, c = i & (kCols - 1);
    if (c < ncols) {
      const float2 v = s[i];
      t[img + (size_t)r * w + c0 + c] = make_float2(v.x * scale, v.y * scale);
    }
  }
}

int ilog2(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return l;
}

}  // namespace

// x, k0, y, scratch: (batch, h, w, 2) float32, k0 may be null (zero);
// mask: (batch, h, w) float32;
// tw_h, tw_w: (n/2, 2) float32 twiddles exp(-2*pi*i*k/n) for n = h, w.
// Launches on `stream`; returns cudaGetLastError() after the launches.
extern "C" int dc_forward(const void* x, const void* k0, const void* mask,
                          void* y, void* scratch, const void* tw_h,
                          const void* tw_w, int batch, int h, int w,
                          void* stream) {
  if (h < 2 || w < 2 || h > kMaxH || w > kRowElems || (h & (h - 1)) ||
      (w & (w - 1)) || batch < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const int logh = ilog2(h), logw = ilog2(w);
  const float sh = (float)(1.0 / sqrt((double)h));
  const float sw = (float)(1.0 / sqrt((double)w));
  const long rows = (long)batch * h;
  const int lines = kRowElems / w;
  const unsigned grid_rows = (unsigned)((rows + lines - 1) / lines);
  float2* t = (float2*)scratch;

  row_fft<false><<<grid_rows, kThreads, 0, st>>>(
      (const float2*)x, t, rows, w, logw, (const float2*)tw_w, sw);
  dim3 grid_cols((w + kCols - 1) / kCols, batch);
  if (k0 != nullptr) {
    col_dc<true><<<grid_cols, kThreads, 0, st>>>(
        t, (const float2*)k0, (const float*)mask, h, logh, w,
        (const float2*)tw_h, sh);
  } else {
    col_dc<false><<<grid_cols, kThreads, 0, st>>>(
        t, nullptr, (const float*)mask, h, logh, w, (const float2*)tw_h, sh);
  }
  row_fft<true><<<grid_rows, kThreads, 0, st>>>(
      t, (float2*)y, rows, w, logw, (const float2*)tw_w, sw);
  return (int)cudaGetLastError();
}
