// Radix-2 Stockham FFT along one strided axis, in shared memory, FP32, for
// sm_90a.
//
// Replaces the five Pallas TPU kernels of professad_tpu/ops/vpufft.py, all
// of which are the same radix-2 Stockham sweep (_stockham_body,
// _stockham_body_mid) over a strided axis:
//   _fft_call            (vpufft.py:145) -> stockham_fft_sublane
//   _fft_real_call       (vpufft.py:182) -> stockham_fft_sublane_real
//   _ifft_real_out_call  (vpufft.py:222) -> stockham_ifft_sublane_real_out
//   _sublane_conv_call   (vpufft.py:274) -> stockham_sublane_conv
//   _fft_mid_call        (vpufft.py:346) -> stockham_fft_mid
//
// Layout.  Every variant transforms the middle axis of an (outer, n, inner)
// f32 array: axis 0 of an (n, B) batch is outer = 1, inner = B; axis 1 of
// an (n0, n1, n2) cube is outer = n0, n = n1, inner = n2.  Complex values are
// separate re / im planes, as in the JAX module.
//
// Design.  One block owns a tile of n rows x W columns (W a power of two,
// at most 32) of one outer slab: columns are contiguous in memory, so the
// load and the store are coalesced along the row.  The tile is loaded once
// into dynamic shared memory, the log2(n) stages run there between two
// ping-pong buffers with __syncthreads between stages, and the tile is
// written once: one read and one write of device memory per call.  Rows are
// padded to W + 1 floats to spread power-of-two strides over the banks.
// Stage s (l = 2^s) reads x[u] and x[u + n/2] and writes
// y[2 g l + k] = a + w b, y[2 g l + l + k] = a - w b for u = g l + k, with
// w = exp(-+ 2 pi i k / (2 l)) = tw[k n / (2 l)] from one table of n/2
// values computed in double on the host; the output is in natural order.
//
// Bound.  Every variant moves its inputs and outputs once and does
// 5 n log2(n) flops per column (twice for the fused convolution), i.e. a
// few flops per byte: it is bound by device memory (3.35 TB/s), not by the
// FP32 rate.  The tile size keeps the shared memory of a block near 70 KB
// so three blocks fit on an SM.
//
// Each C entry returns cudaGetLastError() after its launch; the Python
// wrapper raises if it is not 0.  The kernel allocates nothing.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

enum Mode { kFFT = 0, kRealIn = 1, kRealOut = 2, kConv = 3 };

struct Planes {
  float* re[2];
  float* im[2];
};

// log2(n) radix-2 stages on the tile, starting in buffer `cur`; returns the
// buffer that holds the result.  sign = +1 forward, -1 inverse (the table
// holds exp(-2 pi i j / n); the inverse takes its conjugate).
__device__ int sweep(const Planes& p, int cur, int n, int log2n, int logw,
                     int pitch, const float2* __restrict__ tw, float sign) {
  const int half = n >> 1;
  const int wmask = (1 << logw) - 1;
  for (int s = 0; s < log2n; ++s) {
    const int l = 1 << s;
    const int tstep = half >> s;  // n / (2 l)
    const float* ir = p.re[cur];
    const float* ii = p.im[cur];
    float* orr = p.re[cur ^ 1];
    float* oi = p.im[cur ^ 1];
    for (int e = threadIdx.x; e < (half << logw); e += blockDim.x) {
      const int u = e >> logw;
      const int c = e & wmask;
      const int g = u >> s;
      const int k = u & (l - 1);
      const float2 w = tw[k * tstep];
      const float wr = w.x;
      const float wi = sign * w.y;
      const float ar = ir[u * pitch + c];
      const float ai = ii[u * pitch + c];
      const float br = ir[(u + half) * pitch + c];
      const float bi = ii[(u + half) * pitch + c];
      const float pr = wr * br - wi * bi;
      const float pi = wr * bi + wi * br;
      const int o = (g << (s + 1)) + k;
      orr[o * pitch + c] = ar + pr;
      oi[o * pitch + c] = ai + pi;
      orr[(o + l) * pitch + c] = ar - pr;
      oi[(o + l) * pitch + c] = ai - pi;
    }
    __syncthreads();
    cur ^= 1;
  }
  return cur;
}

template <int MODE>
__global__ void stockham_kernel(const float* __restrict__ xr,
                                const float* __restrict__ xi,
                                const float* __restrict__ kmul,
                                float* __restrict__ yr, float* __restrict__ yi,
                                const float2* __restrict__ tw, int n,
                                int log2n, int inner, int logw, int inverse) {
  extern __shared__ float smem[];
  const int W = 1 << logw;
  const int pitch = W + 1;
  const int plane = n * pitch;
  Planes p;
  p.re[0] = smem;
  p.im[0] = smem + plane;
  p.re[1] = smem + 2 * plane;
  p.im[1] = smem + 3 * plane;

  const int c0 = blockIdx.x * W;
  const int ncols = min(W, inner - c0);
  const size_t base = (size_t)blockIdx.y * n * inner + c0;

  // load the tile; columns past the edge of the array are zeros
  for (int e = threadIdx.x; e < (n << logw); e += blockDim.x) {
    const int r = e >> logw;
    const int c = e & (W - 1);
    float vr = 0.f, vi = 0.f;
    if (c < ncols) {
      const size_t gidx = base + (size_t)r * inner + c;
      vr = xr[gidx];
      if (MODE != kRealIn) vi = xi[gidx];
    }
    p.re[0][r * pitch + c] = vr;
    p.im[0][r * pitch + c] = vi;
  }
  __syncthreads();

  const bool inv = (MODE == kRealOut) || (MODE == kFFT && inverse);
  int cur = sweep(p, 0, n, log2n, logw, pitch, tw, inv ? -1.f : 1.f);
  if (MODE == kConv) {
    for (int e = threadIdx.x; e < (n << logw); e += blockDim.x) {
      const int r = e >> logw;
      const int c = e & (W - 1);
      if (c < ncols) {
        const float kv = kmul[base + (size_t)r * inner + c];
        p.re[cur][r * pitch + c] *= kv;
        p.im[cur][r * pitch + c] *= kv;
      }
    }
    __syncthreads();
    cur = sweep(p, cur, n, log2n, logw, pitch, tw, -1.f);
  }

  const bool scaled = inv || MODE == kConv;
  const float scale = scaled ? 1.f / (float)n : 1.f;
  for (int e = threadIdx.x; e < (n << logw); e += blockDim.x) {
    const int r = e >> logw;
    const int c = e & (W - 1);
    if (c < ncols) {
      const size_t gidx = base + (size_t)r * inner + c;
      yr[gidx] = p.re[cur][r * pitch + c] * scale;
      if (MODE != kRealOut) yi[gidx] = p.im[cur][r * pitch + c] * scale;
    }
  }
}

int ilog2(int v) {
  int r = 0;
  while ((1 << r) < v) ++r;
  return r;
}

template <int MODE>
int launch(const float* xr, const float* xi, const float* kmul, float* yr,
           float* yi, const float* tw, int outer, int n, int inner, int W,
           int inverse, void* stream) {
  const int logw = ilog2(W);
  const size_t smem = (size_t)4 * n * (W + 1) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      stockham_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((inner + W - 1) / W, outer);
  stockham_kernel<MODE><<<grid, 256, smem, (cudaStream_t)stream>>>(
      xr, xi, kmul, yr, yi, reinterpret_cast<const float2*>(tw), n, ilog2(n),
      inner, logw, inverse);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// fft_sublane / ifft_sublane: complex FFT along axis 0 of (n, B); the
// inverse is scaled by 1/n.
int stockham_fft_sublane(const float* xr, const float* xi, float* yr,
                         float* yi, const float* tw, int n, int B, int W,
                         int inverse, void* stream) {
  return launch<kFFT>(xr, xi, nullptr, yr, yi, tw, 1, n, B, W, inverse,
                      stream);
}

// fft_sublane_real: forward FFT along axis 0 of a real (n, B) batch; the
// imaginary input is made as zeros in shared memory.
int stockham_fft_sublane_real(const float* xr, float* yr, float* yi,
                              const float* tw, int n, int B, int W,
                              void* stream) {
  return launch<kRealIn>(xr, nullptr, nullptr, yr, yi, tw, 1, n, B, W, 0,
                         stream);
}

// ifft_sublane_real_out: inverse FFT along axis 0, real part only, 1/n.
int stockham_ifft_sublane_real_out(const float* xr, const float* xi,
                                   float* y, const float* tw, int n, int B,
                                   int W, void* stream) {
  return launch<kRealOut>(xr, xi, nullptr, y, nullptr, tw, 1, n, B, W, 1,
                          stream);
}

// sublane_conv: forward FFT, x real full-length k, inverse FFT (1/n) along
// axis 0, in one residency of the tile.
int stockham_sublane_conv(const float* xr, const float* xi, const float* k,
                          float* yr, float* yi, const float* tw, int n, int B,
                          int W, void* stream) {
  return launch<kConv>(xr, xi, k, yr, yi, tw, 1, n, B, W, 0, stream);
}

// fft_mid / ifft_mid: complex FFT along axis 1 of (n0, n1, n2), batched
// over n0 x n2; the inverse is scaled by 1/n1.
int stockham_fft_mid(const float* xr, const float* xi, float* yr, float* yi,
                     const float* tw, int n0, int n1, int n2, int W,
                     int inverse, void* stream) {
  return launch<kFFT>(xr, xi, nullptr, yr, yi, tw, n0, n1, n2, W, inverse,
                      stream);
}

}  // extern "C"
