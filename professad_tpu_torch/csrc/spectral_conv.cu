// Fused spectral convolution y = irfftn(K * rfftn(x)) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel professad_tpu/ops/pallas_fft.py::spectral_conv
// (three pl.pallas_call passes built in _make_kernels), which the JAX package
// routes its dedicated convolutions through: the vW Laplacian, the Wang-Teter
// kernel and the exact preconditioner.
//
// What it computes, for real x (n0, n1, n2) and a real half-spectrum K
// (n0, n1, m2), m2 = n2/2 + 1, in the torch.fft / jnp.fft convention:
//   1. real DFT along z                     x   -> a   (n0, n1, m2) complex
//   2. complex DFT along y                  a   -> b
//   3. complex DFT along x, times K         b   -> a
//   4. inverse complex DFT along x          a   -> b
//   5. inverse complex DFT along y          b   -> a
//   6. inverse real DFT along z, Hermitian weights 1 / 2 / 1 and the 1/N
//      normalisation; the imaginary parts of the kz = 0 and Nyquist columns
//      are dropped, as a c2r transform does.
//
// What bounds it on this card: every pass is a direct O(n) DFT per output,
// so a 128^3 convolution is ~2.7e9 FMAs on the CUDA cores (FP32 or FP64,
// never TF32 or tensor cores: the TPU kernel needed Precision.HIGHEST for
// f32 accuracy), against ~50 MB of device-memory traffic; it is bound by
// FMA issue and by the L1/L2 traffic of re-reading each line n times, not by
// HBM.  What the design does about it: one thread per output, with the
// contraction axis walked so that a warp's loads are coalesced (x, y
// passes: neighbouring threads read neighbouring kz) or broadcast (z
// passes: the warp shares one row); twiddles come from a length-n cos/sin
// table computed in double on the host and indexed by (j*k) mod n, which
// reduces every angle exactly and keeps the error at table rounding.  The
// complex intermediates live in two device buffers the caller allocates.
// Shared-memory Stockham passes, TMA and pass fusion are later work.
//
// C interface (loaded with ctypes): each entry point launches the six passes
// on the given stream and returns cudaGetLastError().

#include <cuda_runtime.h>

template <typename T> struct Complex;
template <> struct Complex<float> { typedef float2 type; };
template <> struct Complex<double> { typedef double2 type; };

template <typename T>
__device__ __forceinline__ typename Complex<T>::type make_c(T re, T im) {
    typename Complex<T>::type v;
    v.x = re;
    v.y = im;
    return v;
}

// 1. real DFT along the contiguous axis: x (rows, n) -> out (rows, m)
template <typename T>
__global__ void rdft_last(const T* __restrict__ x,
                          typename Complex<T>::type* __restrict__ out,
                          const typename Complex<T>::type* __restrict__ tw,
                          long long rows, int n, int m) {
    long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= rows * m) return;
    long long r = t / m;
    int k = (int)(t - r * m);
    const T* row = x + r * n;
    T re = 0, im = 0;
    int jk = 0;                         // (j * k) mod n
    for (int j = 0; j < n; ++j) {
        T v = row[j];
        typename Complex<T>::type w = tw[jk];
        re += v * w.x;                  // v e^{-i theta}
        im -= v * w.y;
        jk += k;
        if (jk >= n) jk -= n;
    }
    out[t] = make_c<T>(re, im);
}

// 2-5. complex DFT along a middle axis of (outer, n, inner); forward uses
// e^{-i theta}, inverse e^{+i theta} (unnormalised).  MULK multiplies the
// result by the real K, laid out like the output.
template <typename T, bool INVERSE, bool MULK>
__global__ void dft_axis(const typename Complex<T>::type* __restrict__ in,
                         typename Complex<T>::type* __restrict__ out,
                         const typename Complex<T>::type* __restrict__ tw,
                         const T* __restrict__ K,
                         long long outer, int n, long long inner) {
    long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= outer * n * inner) return;
    long long c = t % inner;
    long long rest = t / inner;
    int k = (int)(rest % n);
    long long o = rest / n;
    const typename Complex<T>::type* base = in + o * (long long)n * inner + c;
    T re = 0, im = 0;
    int jk = 0;
    for (int j = 0; j < n; ++j) {
        typename Complex<T>::type v = base[(long long)j * inner];
        typename Complex<T>::type w = tw[jk];
        if (INVERSE) {
            re += v.x * w.x - v.y * w.y;
            im += v.y * w.x + v.x * w.y;
        } else {
            re += v.x * w.x + v.y * w.y;
            im += v.y * w.x - v.x * w.y;
        }
        jk += k;
        if (jk >= n) jk -= n;
    }
    if (MULK) {
        T kv = K[t];
        re *= kv;
        im *= kv;
    }
    out[t] = make_c<T>(re, im);
}

// 6. inverse real DFT along the contiguous axis: in (rows, m) -> y (rows, n)
template <typename T>
__global__ void irdft_last(const typename Complex<T>::type* __restrict__ in,
                           T* __restrict__ y,
                           const typename Complex<T>::type* __restrict__ tw,
                           long long rows, int n, int m, T scale) {
    long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= rows * n) return;
    long long r = t / n;
    int z = (int)(t - r * n);
    const typename Complex<T>::type* row = in + r * m;
    T acc = 0;
    int jk = 0;                         // (k * z) mod n
    for (int k = 0; k < m; ++k) {
        typename Complex<T>::type v = row[k];
        typename Complex<T>::type w = tw[jk];
        T term = v.x * w.x - v.y * w.y;   // Re(v e^{+i theta})
        acc += (k == 0 || 2 * k == n) ? term : T(2) * term;
        jk += z;
        if (jk >= n) jk -= n;
    }
    y[t] = acc * scale;
}

static inline unsigned int n_blocks(long long n, int tpb) {
    return (unsigned int)((n + tpb - 1) / tpb);
}

template <typename T>
static int run(const T* x, const T* K, T* y, T* buf_a, T* buf_b,
               const T* tw0, const T* tw1, const T* tw2,
               int n0, int n1, int n2, cudaStream_t stream) {
    typedef typename Complex<T>::type C;
    const int tpb = 256;
    const int m2 = n2 / 2 + 1;
    const long long rows = (long long)n0 * n1;
    const long long nc = rows * m2;
    C* a = reinterpret_cast<C*>(buf_a);
    C* b = reinterpret_cast<C*>(buf_b);
    const C* t0 = reinterpret_cast<const C*>(tw0);
    const C* t1 = reinterpret_cast<const C*>(tw1);
    const C* t2 = reinterpret_cast<const C*>(tw2);
    const unsigned int gc = n_blocks(nc, tpb);

    rdft_last<T><<<gc, tpb, 0, stream>>>(x, a, t2, rows, n2, m2);
    dft_axis<T, false, false><<<gc, tpb, 0, stream>>>(a, b, t1, nullptr,
                                                      n0, n1, m2);
    dft_axis<T, false, true><<<gc, tpb, 0, stream>>>(b, a, t0, K,
                                                     1, n0, rows / n0 * m2);
    dft_axis<T, true, false><<<gc, tpb, 0, stream>>>(a, b, t0, nullptr,
                                                     1, n0, rows / n0 * m2);
    dft_axis<T, true, false><<<gc, tpb, 0, stream>>>(b, a, t1, nullptr,
                                                     n0, n1, m2);
    const T scale = T(1) / (T(n0) * T(n1) * T(n2));
    irdft_last<T><<<n_blocks(rows * n2, tpb), tpb, 0, stream>>>(
        a, y, t2, rows, n2, m2, scale);
    return (int)cudaGetLastError();
}

extern "C" int spectral_conv_f32(const float* x, const float* K, float* y,
                                 float* buf_a, float* buf_b,
                                 const float* tw0, const float* tw1,
                                 const float* tw2, int n0, int n1, int n2,
                                 void* stream) {
    return run<float>(x, K, y, buf_a, buf_b, tw0, tw1, tw2, n0, n1, n2,
                      static_cast<cudaStream_t>(stream));
}

extern "C" int spectral_conv_f64(const double* x, const double* K, double* y,
                                 double* buf_a, double* buf_b,
                                 const double* tw0, const double* tw1,
                                 const double* tw2, int n0, int n1, int n2,
                                 void* stream) {
    return run<double>(x, K, y, buf_a, buf_b, tw0, tw1, tw2, n0, n1, n2,
                       static_cast<cudaStream_t>(stream));
}
