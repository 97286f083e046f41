// Stockham FFT along one strided axis of f32 (re, im) planes, for sm_90a,
// on the shared-memory core of fft_core.cuh.
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
// up to 32, with n W <= 4096: 16 columns, 64-byte row segments of each
// plane, at n = 256) of one outer slab.  The tile is loaded once, coalesced
// along the row and with all of a thread's loads in flight together, into
// one interleaved float2 buffer in shared memory; the core's radix-4 (and
// one radix-2) stages run there with registers in place of a second buffer;
// the tile is written once: one read and one write of device memory per
// call.
//
// Bound.  Every variant moves its inputs and outputs once and does
// 5 n log2(n) flops per column (twice for the fused convolution), a few
// flops per byte: it is bound by device memory (3.35 TB/s), not by the FP32
// rate.  A 256 x 16 tile takes 35 KB and 512 threads of ~50 registers, so
// two blocks share an SM.
//
// Each C entry returns the first CUDA error of its launch, or 0; the Python
// wrapper raises if it is not 0.  The kernel allocates nothing.

#include <cuda_runtime.h>
#include <stddef.h>

#include "fft_core.cuh"

namespace {

enum Mode { kFFT = 0, kRealIn = 1, kRealOut = 2, kConv = 3 };

template <int MODE>
__global__ void __launch_bounds__(fftcore::kMaxThreads)
stockham_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                const float* __restrict__ kmul, float* __restrict__ yr,
                float* __restrict__ yi, const float2* __restrict__ tw,
                const int* __restrict__ plan, int nst, int ntw, int n,
                int inner, int logw, int inverse) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float2* s = reinterpret_cast<float2*>(smem_raw);
  const int W = 1 << logw;
  const int pitch = W + 1;
  const float2* stw;
  const int* splan;
  fftcore::stage_tables(s + n * pitch, tw, ntw, plan, nst, &stw, &splan);
  const int c0 = blockIdx.x * W;
  const int nc = min(W, inner - c0);
  const size_t base = (size_t)blockIdx.y * n * inner + c0;

  // load the tile; columns past the edge of the array are zeros
  fftcore::gather(s, n << logw, logw, pitch, [&](int e) {
    const int c = e & (W - 1);
    float2 v = make_float2(0.f, 0.f);
    if (c < nc) {
      const size_t g = base + (size_t)(e >> logw) * inner + c;
      v.x = xr[g];
      if (MODE != kRealIn) v.y = xi[g];
    }
    return v;
  });

  const bool inv = (MODE == kRealOut) || (MODE == kFFT && inverse);
  fftcore::fft_tile<float, false>(s, n, logw, pitch, splan, nst, stw, inv);
  if (MODE == kConv) {
    fftcore::scale_tile(s, n << logw, logw, pitch, [&](int e) {
      const int c = e & (W - 1);
      return c < nc ? kmul[base + (size_t)(e >> logw) * inner + c] : 0.f;
    });
    fftcore::fft_tile<float, false>(s, n, logw, pitch, splan, nst, stw,
                                    true);
  }

  const float scale = (inv || MODE == kConv) ? 1.f / (float)n : 1.f;
  for (int e = threadIdx.x; e < (n << logw); e += blockDim.x) {
    const int r = e >> logw;
    const int c = e & (W - 1);
    if (c < nc) {
      const size_t g = base + (size_t)r * inner + c;
      const float2 v = s[r * pitch + c];
      yr[g] = v.x * scale;
      if (MODE != kRealOut) yi[g] = v.y * scale;
    }
  }
}

template <int MODE>
int launch(const float* xr, const float* xi, const float* kmul, float* yr,
           float* yi, const float* tw, const int* plan, int nst, int ntw,
           int outer, int n, int inner, int W, int inverse, void* stream) {
  const size_t smem = fftcore::tile_smem<float>(n, W, ntw, nst);
  cudaError_t err = fftcore::allow_smem(stockham_kernel<MODE>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((inner + W - 1) / W, outer);
  stockham_kernel<MODE><<<grid, fftcore::tile_threads(n, W), smem,
                          (cudaStream_t)stream>>>(
      xr, xi, kmul, yr, yi, reinterpret_cast<const float2*>(tw), plan, nst,
      ntw, n, inner, fftcore::ilog2(W), inverse);
  return (int)cudaGetLastError();
}

}  // namespace

// Every entry takes the twiddles, the stage plan, its stage count and the
// twiddle count of the transform axis (ops/fft_plan.py) and the tile width
// W (a power of two).
extern "C" {

// fft_sublane / ifft_sublane: complex FFT along axis 0 of (n, B); the
// inverse is scaled by 1/n.
int stockham_fft_sublane(const float* xr, const float* xi, float* yr,
                         float* yi, const float* tw, const int* plan, int nst,
                         int ntw, int n, int B, int W, int inverse,
                         void* stream) {
  return launch<kFFT>(xr, xi, nullptr, yr, yi, tw, plan, nst, ntw, 1, n, B,
                      W, inverse, stream);
}

// fft_sublane_real: forward FFT along axis 0 of a real (n, B) batch; the
// imaginary input is made as zeros in shared memory.
int stockham_fft_sublane_real(const float* xr, float* yr, float* yi,
                              const float* tw, const int* plan, int nst,
                              int ntw, int n, int B, int W, void* stream) {
  return launch<kRealIn>(xr, nullptr, nullptr, yr, yi, tw, plan, nst, ntw, 1,
                         n, B, W, 0, stream);
}

// ifft_sublane_real_out: inverse FFT along axis 0, real part only, 1/n.
int stockham_ifft_sublane_real_out(const float* xr, const float* xi,
                                   float* y, const float* tw, const int* plan,
                                   int nst, int ntw, int n, int B, int W,
                                   void* stream) {
  return launch<kRealOut>(xr, xi, nullptr, y, nullptr, tw, plan, nst, ntw, 1,
                          n, B, W, 1, stream);
}

// sublane_conv: forward FFT, x real full-length k, inverse FFT (1/n) along
// axis 0, in one residency of the tile.
int stockham_sublane_conv(const float* xr, const float* xi, const float* k,
                          float* yr, float* yi, const float* tw,
                          const int* plan, int nst, int ntw, int n, int B,
                          int W, void* stream) {
  return launch<kConv>(xr, xi, k, yr, yi, tw, plan, nst, ntw, 1, n, B, W, 0,
                       stream);
}

// fft_mid / ifft_mid: complex FFT along axis 1 of (n0, n1, n2), batched
// over n0 x n2; the inverse is scaled by 1/n1.
int stockham_fft_mid(const float* xr, const float* xi, float* yr, float* yi,
                     const float* tw, const int* plan, int nst, int ntw,
                     int n0, int n1, int n2, int W, int inverse,
                     void* stream) {
  return launch<kFFT>(xr, xi, nullptr, yr, yi, tw, plan, nst, ntw, n0, n1,
                      n2, W, inverse, stream);
}

}  // extern "C"
