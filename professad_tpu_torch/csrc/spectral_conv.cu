// Fused spectral convolution y = irfftn(K * rfftn(x)) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel professad_tpu/ops/pallas_fft.py::spectral_conv
// (three pl.pallas_call passes built in _make_kernels), which the JAX package
// routes its dedicated convolutions through: the vW Laplacian, the Wang-Teter
// kernel and the exact preconditioner.
//
// What it computes, for real x (n0, n1, n2) and a real half-spectrum K
// (n0, n1, m2), m2 = n2/2 + 1, in the torch.fft / jnp.fft convention, in five
// launches over one complex (n0, n1, m2) intermediate the caller allocates.
// A batch of B such convolutions (x and y (B, n0, n1, n2), lanes contiguous,
// the lanes' K kstride values apart: n0 n1 m2 for one K per lane, 0 for one K
// shared by all) takes the same five launches: the z passes treat the batch
// as B n0 n1 rows and the y passes as B n0 planes, and the x pass (the only
// one whose lines cross the planes of a lane) takes the lane from blockIdx.y.
// This is what the Pallas kernel computes under jax.vmap, where its batching
// rule runs one program over the lanes.
//   1. real FFT along z                      x -> buf
//   2. FFT along y                           buf -> buf (in place)
//   3. FFT along x, times K, inverse FFT     buf -> buf (in place)
//   4. inverse FFT along y                   buf -> buf (in place)
//   5. inverse real FFT along z and 1/N      buf -> y
// Every pass is the shared-memory Stockham core of fft_core.cuh on a tile of
// one axis x W columns: O(n log n) per line for composite n (a prime factor
// p >= 7 costs a direct p-point DFT stage).  The passes along y and x
// transform the middle axis of (outer, n, inner) tiles whose W columns are
// contiguous: W x sizeof(complex) = 128 bytes per row segment.  A tile is read
// whole before it is written, so those passes run in place.
//
// The z passes pack two real rows into one complex line: rows r and r + W of
// a tile of 2W rows are the real and imaginary parts of column r.  Forward,
// X_a[k] = (Z[k] + conj Z[n-k]) / 2 and X_b[k] = (Z[k] - conj Z[n-k]) / 2i.
// Inverse, Z = A + i B over the Hermitian extension of both half spectra,
// with the imaginary parts of the kz = 0 column and, for even n2, of the
// Nyquist column dropped, as a c2r transform does; y_a = Re z, y_b = Im z.
//
// What bounds it on this card: x, K and y are 21 MB at 128^3 f32, 6.3 us at
// 3.35 TB/s; the FFT work (~0.22 GFLOP) is 3.3 us at the FP32 rate (FP32 or
// FP64 FMAs, never TF32: the TPU kernel needed Precision.HIGHEST for f32
// accuracy).  The five launches move ~89 MB (the intermediate mostly through
// the 50 MB L2), so the design is bound by that traffic and by the stage
// synchronisations, not by arithmetic.
//
// C interface (loaded with ctypes): each entry point launches the five
// passes on the given stream and returns the first CUDA error, or 0.

#include <cuda_runtime.h>

#include "fft_core.cuh"

namespace {

using fftcore::Cx;
using fftcore::cx;

struct Axis {
  int n;          // length
  int logw;       // log2 of the tile's columns
  int nst;        // stages
  int ntw;        // twiddles
  const int* plan;
};

// 1. real FFT along the contiguous axis: x (rows, n) -> out (rows, m)
template <typename T, bool MIXED>
__global__ void __launch_bounds__(fftcore::kMaxThreads)
rfft_z(const T* __restrict__ x, typename Cx<T>::type* __restrict__ out,
       const typename Cx<T>::type* __restrict__ tw, Axis a, long long rows) {
  typedef typename Cx<T>::type C;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  C* s = reinterpret_cast<C*>(smem_raw);
  const int n = a.n, W = 1 << a.logw, pitch = W + 1, m = n / 2 + 1;
  const long long r0 = (long long)blockIdx.x * 2 * W;
  const long long nv = min((long long)2 * W, rows - r0);  // valid rows
  // 2W rows of n reals, all of a thread's loads issued before its stores
  const C* stw;
  const int* splan;
  fftcore::stage_tables(s + n * pitch, tw, a.ntw, a.plan, a.nst, &stw,
                        &splan);
  T* sr = reinterpret_cast<T*>(s);
  T v[2 * fftcore::kPerThread];
  const long long nx = nv * n;
#pragma unroll
  for (int i = 0; i < 2 * fftcore::kPerThread; ++i) {
    const int e = threadIdx.x + i * blockDim.x;
    if (e < 2 * W * n) v[i] = e < nx ? x[r0 * n + e] : T(0);
  }
#pragma unroll
  for (int i = 0; i < 2 * fftcore::kPerThread; ++i) {
    const int e = threadIdx.x + i * blockDim.x;
    if (e < 2 * W * n) {
      const int rr = e / n;
      const int z = e - rr * n;
      sr[2 * (z * pitch + (rr & (W - 1))) + (rr >> a.logw)] = v[i];
    }
  }
  __pipeline_wait_prior(0);  // the stage tables
  __syncthreads();
  fftcore::fft_tile<T, MIXED>(s, n, a.logw, pitch, splan, a.nst, stw, false);
  for (int e = threadIdx.x; e < nv * m; e += blockDim.x) {
    const int rr = e / m;
    const int k = e - rr * m;
    const int c = rr & (W - 1);
    const C z1 = s[k * pitch + c];
    const C z2 = s[(k == 0 ? 0 : n - k) * pitch + c];
    const T h = T(0.5);
    out[r0 * m + e] = (rr < W)
        ? cx<T>(h * (z1.x + z2.x), h * (z1.y - z2.y))
        : cx<T>(h * (z1.y + z2.y), h * (z2.x - z1.x));
  }
}

// 2-4. FFT along the middle axis of (outer, n, inner), in place, one outer
// index per blockIdx.y.  MULK: forward, times the real K (laid out like one
// outer index of the data, kstride values per outer index), inverse.
template <typename T, bool MIXED, bool MULK>
__global__ void __launch_bounds__(fftcore::kMaxThreads)
fft_mid(typename Cx<T>::type* __restrict__ buf, const T* __restrict__ K,
        const typename Cx<T>::type* __restrict__ tw, Axis a, long long inner,
        long long kstride, int inverse) {
  typedef typename Cx<T>::type C;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  C* s = reinterpret_cast<C*>(smem_raw);
  const int n = a.n, W = 1 << a.logw, pitch = W + 1;
  const long long c0 = (long long)blockIdx.x * W;
  const int nc = (int)min((long long)W, inner - c0);
  const long long base = (long long)blockIdx.y * n * inner + c0;
  const long long kbase = (long long)blockIdx.y * kstride + c0;
  const C* stw;
  const int* splan;
  fftcore::stage_tables(s + n * pitch, tw, a.ntw, a.plan, a.nst, &stw,
                        &splan);
  fftcore::gather(s, n << a.logw, a.logw, pitch, [&](int e) {
    const int c = e & (W - 1);
    return c < nc ? buf[base + (e >> a.logw) * inner + c]
                  : cx<T>(T(0), T(0));
  });
  fftcore::fft_tile<T, MIXED>(s, n, a.logw, pitch, splan, a.nst, stw,
                       !MULK && inverse);
  if (MULK) {
    fftcore::scale_tile(s, n << a.logw, a.logw, pitch, [&](int e) {
      const int c = e & (W - 1);
      return c < nc ? K[kbase + (e >> a.logw) * inner + c] : T(0);
    });
    fftcore::fft_tile<T, MIXED>(s, n, a.logw, pitch, splan, a.nst, stw, true);
  }
  for (int e = threadIdx.x; e < (n << a.logw); e += blockDim.x) {
    const int r = e >> a.logw;
    const int c = e & (W - 1);
    if (c < nc) buf[base + r * inner + c] = s[r * pitch + c];
  }
}

// 5. inverse real FFT along the contiguous axis: in (rows, m) -> y (rows, n)
template <typename T, bool MIXED>
__global__ void __launch_bounds__(fftcore::kMaxThreads)
irfft_z(const typename Cx<T>::type* __restrict__ in, T* __restrict__ y,
        const typename Cx<T>::type* __restrict__ tw, Axis a, long long rows,
        T scale) {
  typedef typename Cx<T>::type C;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  C* s = reinterpret_cast<C*>(smem_raw);
  const int n = a.n, W = 1 << a.logw, pitch = W + 1, m = n / 2 + 1;
  const long long r0 = (long long)blockIdx.x * 2 * W;
  const long long nv = min((long long)2 * W, rows - r0);
  const C* stw;
  const int* splan;
  fftcore::stage_tables(s + n * pitch, tw, a.ntw, a.plan, a.nst, &stw,
                        &splan);
  // Z = A + i B in two sweeps: the A rows set Z[k] and Z[n-k], then the B
  // rows add i B[k] and i conj B[k] to them.
  for (int part = 0; part < 2; ++part) {
    // W rows of m values, all of a thread's loads issued before its stores
    C u[fftcore::kPerThread];
    const long long nx = min((long long)W, nv - part * W) * m;
#pragma unroll
    for (int i = 0; i < fftcore::kPerThread; ++i) {
      const int e = threadIdx.x + i * blockDim.x;
      if (e < W * m)
        u[i] = e < nx ? in[(r0 + part * W) * m + e] : cx<T>(T(0), T(0));
    }
#pragma unroll
    for (int i = 0; i < fftcore::kPerThread; ++i) {
      const int e = threadIdx.x + i * blockDim.x;
      if (e >= W * m) continue;
      const int c = e / m;
      const int k = e - c * m;
      C v = u[i];
      if (k == 0 || 2 * k == n) v.y = T(0);
      const bool mirror = k > 0 && n - k >= m;
      C* zk = &s[k * pitch + c];
      C* zm = &s[(n - k) * pitch + c];
      if (part == 0) {
        *zk = v;
        if (mirror) *zm = cx<T>(v.x, -v.y);
      } else {
        zk->x -= v.y;
        zk->y += v.x;
        if (mirror) {
          zm->x += v.y;
          zm->y += v.x;
        }
      }
    }
    __pipeline_wait_prior(0);  // the stage tables
    __syncthreads();
  }
  fftcore::fft_tile<T, MIXED>(s, n, a.logw, pitch, splan, a.nst, stw, true);
  for (int e = threadIdx.x; e < nv * n; e += blockDim.x) {
    const int rr = e / n;
    const int z = e - rr * n;
    const C v = s[z * pitch + (rr & (W - 1))];
    y[r0 * n + e] = scale * ((rr < W) ? v.x : v.y);
  }
}

Axis axis(int n, int w, int nst, int ntw, const int* plan) {
  Axis a;
  a.n = n;
  a.logw = fftcore::ilog2(w);
  a.nst = nst;
  a.ntw = ntw;
  a.plan = plan;
  return a;
}

template <typename T, bool MIXED>
int run(const T* x, const T* K, T* y, T* buf_raw, const T* tw0,
        const T* tw1, const T* tw2, const int* pl0, const int* pl1,
        const int* pl2, int nst0, int nst1, int nst2, int ntw0, int ntw1,
        int ntw2, int n0, int n1, int n2, int wz, int wy, int wx, int B,
        long long kstride, cudaStream_t stream) {
  typedef typename Cx<T>::type C;
  using fftcore::tile_smem;
  using fftcore::tile_threads;
  const int m2 = n2 / 2 + 1;
  const long long rows = (long long)B * n0 * n1;
  const long long inner_x = (long long)n1 * m2;
  // gridDim.y of the y passes (B n0 planes) and of the x pass (B lanes)
  if (B < 1 || (long long)B * n0 > 65535) return (int)cudaErrorInvalidValue;
  C* buf = reinterpret_cast<C*>(buf_raw);
  const C* t0 = reinterpret_cast<const C*>(tw0);
  const C* t1 = reinterpret_cast<const C*>(tw1);
  const C* t2 = reinterpret_cast<const C*>(tw2);
  const Axis az = axis(n2, wz, nst2, ntw2, pl2);
  const Axis ay = axis(n1, wy, nst1, ntw1, pl1);
  const Axis ax = axis(n0, wx, nst0, ntw0, pl0);
  const size_t sz = tile_smem<T>(n2, wz, ntw2, nst2),
               sy = tile_smem<T>(n1, wy, ntw1, nst1),
               sx = tile_smem<T>(n0, wx, ntw0, nst0);
  cudaError_t err;
  if ((err = fftcore::allow_smem(rfft_z<T, MIXED>, sz)) != cudaSuccess ||
      (err = fftcore::allow_smem(irfft_z<T, MIXED>, sz)) != cudaSuccess ||
      (err = fftcore::allow_smem(fft_mid<T, MIXED, false>, sy)) !=
          cudaSuccess ||
      (err = fftcore::allow_smem(fft_mid<T, MIXED, true>, sx)) !=
          cudaSuccess)
    return (int)err;

  const unsigned gz = (unsigned)((rows + 2 * wz - 1) / (2 * wz));
  const dim3 gy((m2 + wy - 1) / wy, (unsigned)(B * n0));
  const dim3 gx((unsigned)((inner_x + wx - 1) / wx), (unsigned)B);
  const T scale = T(1) / (T(n0) * T(n1) * T(n2));
  rfft_z<T, MIXED><<<gz, tile_threads(n2, wz), sz, stream>>>(x, buf, t2, az,
                                                             rows);
  fft_mid<T, MIXED, false><<<gy, tile_threads(n1, wy), sy, stream>>>(
      buf, nullptr, t1, ay, m2, 0, 0);
  fft_mid<T, MIXED, true><<<gx, tile_threads(n0, wx), sx, stream>>>(
      buf, K, t0, ax, inner_x, kstride, 0);
  fft_mid<T, MIXED, false><<<gy, tile_threads(n1, wy), sy, stream>>>(
      buf, nullptr, t1, ay, m2, 0, 1);
  irfft_z<T, MIXED><<<gz, tile_threads(n2, wz), sz, stream>>>(
      buf, y, t2, az, rows, scale);
  return (int)cudaGetLastError();
}

// The power-of-two instance where every axis allows it, else the mixed one.
template <typename T>
int run_any(const T* x, const T* K, T* y, T* buf, const T* tw0, const T* tw1,
            const T* tw2, const int* pl0, const int* pl1, const int* pl2,
            int nst0, int nst1, int nst2, int ntw0, int ntw1, int ntw2,
            int n0, int n1, int n2, int wz, int wy, int wx, int B,
            long long kstride, cudaStream_t stream) {
  using fftcore::is_pow2;
  if (is_pow2(n0) && is_pow2(n1) && is_pow2(n2))
    return run<T, false>(x, K, y, buf, tw0, tw1, tw2, pl0, pl1, pl2, nst0,
                         nst1, nst2, ntw0, ntw1, ntw2, n0, n1, n2, wz, wy, wx,
                         B, kstride, stream);
  return run<T, true>(x, K, y, buf, tw0, tw1, tw2, pl0, pl1, pl2, nst0, nst1,
                      nst2, ntw0, ntw1, ntw2, n0, n1, n2, wz, wy, wx, B,
                      kstride, stream);
}

}  // namespace

// x, K, y: the arrays; buf: (B, n0, n1, m2) complex scratch; twN / plN /
// nstN / ntwN: the twiddles, stage plan, stage count and twiddle count of
// axis N (ops/fft_plan.py); wz, wy, wx: the tile widths of the z, y and x
// passes (powers of two); B: the lanes (B n0 <= 65535); kstride: the values
// between two lanes' K (0: one K for all lanes).
extern "C" int spectral_conv_f32(const float* x, const float* K, float* y,
                                 float* buf, const float* tw0,
                                 const float* tw1, const float* tw2,
                                 const int* pl0, const int* pl1,
                                 const int* pl2, int nst0, int nst1, int nst2,
                                 int ntw0, int ntw1, int ntw2, int n0, int n1,
                                 int n2, int wz, int wy, int wx, int B,
                                 long long kstride, void* stream) {
  return run_any<float>(x, K, y, buf, tw0, tw1, tw2, pl0, pl1, pl2, nst0,
                        nst1, nst2, ntw0, ntw1, ntw2, n0, n1, n2, wz, wy, wx,
                        B, kstride, static_cast<cudaStream_t>(stream));
}

extern "C" int spectral_conv_f64(const double* x, const double* K, double* y,
                                 double* buf, const double* tw0,
                                 const double* tw1, const double* tw2,
                                 const int* pl0, const int* pl1,
                                 const int* pl2, int nst0, int nst1, int nst2,
                                 int ntw0, int ntw1, int ntw2, int n0, int n1,
                                 int n2, int wz, int wy, int wx, int B,
                                 long long kstride, void* stream) {
  return run_any<double>(x, K, y, buf, tw0, tw1, tw2, pl0, pl1, pl2, nst0,
                         nst1, nst2, ntw0, ntw1, ntw2, n0, n1, n2, wz, wy,
                         wx, B, kstride, static_cast<cudaStream_t>(stream));
}
