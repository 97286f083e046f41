// Shared-memory mixed-radix Stockham FFT core for Hopper (sm_90a), shared by
// csrc/spectral_conv.cu and csrc/stockham.cu.
//
// A tile of n rows x W columns of complex values (float2 / double2) lives in
// shared memory, rows padded to W + 1 entries against bank conflicts.  Each
// column is transformed along the row axis by a sequence of self-sorting
// Stockham stages; the output is in natural order, in the same buffer.  The
// caller loads the tile, calls fft_tile, and stores it.
//
// The stage plan comes from the host (ops/fft_plan.py), which factorises n
// into radix-4, radix-2, radix-3 and radix-5 stages and one generic stage for
// every other prime factor, and computes the twiddles in double; they are
// cast to the working type once.  The plan is a device int array of
// (radix, ns, twiddle offset) triples, ns being the product of the radices
// of the earlier stages.  Stage (R, ns), for butterfly j in [0, n / R) with
// k = j mod ns:
//   v[r] = x[j + r n / R] * exp(-2 pi i r k / (ns R))     r in [0, R)
//   y[(j - k) R + k + q ns] = sum_r v[r] exp(-2 pi i q r / R)
// The butterfly stages read their table at k (R - 1) + r - 1; the generic
// stage computes each output directly with the combined table
// exp(-2 pi i t / (ns R)), t in [0, ns R): for a prime axis it is a direct
// DFT, which is right but O(n) per output.  The inverse conjugates every
// twiddle and butterfly constant and is unnormalised.
//
// One buffer, not two: in each stage every thread first reads all of its
// butterflies' inputs into registers, the block synchronises, and then the
// thread writes its outputs over the same tile and the block synchronises
// again.  A thread holds at most kPerThread complex values, so a block has
// ceil(n W / kPerThread) threads (rounded up to a warp, at most kMaxThreads)
// and a tile holds at most kPerThread * kMaxThreads values.  Eight values a
// thread (rather than 16) halves the registers and doubles the warps that
// hide the stages' latency.  The plan and the twiddles are copied to shared
// memory behind the tile once per block.

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace fftcore {

constexpr int kPerThread = 8;     // complex values a thread holds in a stage
constexpr int kMaxThreads = 512;  // so a tile is at most 4096 values

template <typename T> struct Cx;
template <> struct Cx<float> { typedef float2 type; };
template <> struct Cx<double> { typedef double2 type; };

template <typename T>
__device__ __forceinline__ typename Cx<T>::type cx(T re, T im) {
  typename Cx<T>::type v;
  v.x = re;
  v.y = im;
  return v;
}

template <typename C>
__device__ __forceinline__ C cadd(C a, C b) {
  a.x += b.x;
  a.y += b.y;
  return a;
}

template <typename C>
__device__ __forceinline__ C csub(C a, C b) {
  a.x -= b.x;
  a.y -= b.y;
  return a;
}

template <typename C>
__device__ __forceinline__ C cmul(C a, C b) {
  C r;
  r.x = a.x * b.x - a.y * b.y;
  r.y = a.x * b.y + a.y * b.x;
  return r;
}

template <typename C, typename T>
__device__ __forceinline__ C cscale(C a, T s) { a.x *= s; a.y *= s; return a; }

// sg * (-i) * a: the forward (sg = 1) or inverse (sg = -1) quarter turn
template <typename C, typename T>
__device__ __forceinline__ C mj(C a, T sg) {
  C r;
  r.x = sg * a.y;
  r.y = -sg * a.x;
  return r;
}

// R-point DFT in registers, exp(-+ 2 pi i q r / R) for sg = +-1
template <typename T, int R> struct Butterfly;

template <typename T> struct Butterfly<T, 2> {
  template <typename C> __device__ static void run(C* a, T) {
    const C t = a[0];
    a[0] = cadd(t, a[1]);
    a[1] = csub(t, a[1]);
  }
};

template <typename T> struct Butterfly<T, 3> {
  template <typename C> __device__ static void run(C* a, T sg) {
    const T h = T(0.86602540378443864676372317075294);  // sqrt(3) / 2
    const C t = cadd(a[1], a[2]);
    const C d = cscale(mj(csub(a[1], a[2]), sg), h);
    const C b = csub(a[0], cscale(t, T(0.5)));
    a[0] = cadd(a[0], t);
    a[1] = cadd(b, d);
    a[2] = csub(b, d);
  }
};

template <typename T> struct Butterfly<T, 4> {
  template <typename C> __device__ static void run(C* a, T sg) {
    const C t0 = cadd(a[0], a[2]);
    const C t1 = csub(a[0], a[2]);
    const C t2 = cadd(a[1], a[3]);
    const C t3 = mj(csub(a[1], a[3]), sg);
    a[0] = cadd(t0, t2);
    a[1] = cadd(t1, t3);
    a[2] = csub(t0, t2);
    a[3] = csub(t1, t3);
  }
};

template <typename T> struct Butterfly<T, 5> {
  template <typename C> __device__ static void run(C* a, T sg) {
    const T c1 = T(0.30901699437494742410229341718282);   // cos(2 pi / 5)
    const T c2 = T(-0.80901699437494742410229341718282);  // cos(4 pi / 5)
    const T s1 = T(0.95105651629515357211643933337938);   // sin(2 pi / 5)
    const T s2 = T(0.58778525229247312916870595463907);   // sin(4 pi / 5)
    const C t1 = cadd(a[1], a[4]);
    const C t2 = cadd(a[2], a[3]);
    const C t3 = csub(a[1], a[4]);
    const C t4 = csub(a[2], a[3]);
    const C b1 = cadd(a[0], cadd(cscale(t1, c1), cscale(t2, c2)));
    const C b2 = cadd(a[0], cadd(cscale(t1, c2), cscale(t2, c1)));
    const C d1 = mj(cadd(cscale(t3, s1), cscale(t4, s2)), sg);
    const C d2 = mj(csub(cscale(t3, s2), cscale(t4, s1)), sg);
    a[0] = cadd(a[0], cadd(t1, t2));
    a[1] = cadd(b1, d1);
    a[4] = csub(b1, d1);
    a[2] = cadd(b2, d2);
    a[3] = csub(b2, d2);
  }
};

// One radix-R stage (R = 2, 3, 4, 5) over the tile.
template <typename T, int R>
__device__ __forceinline__ void stage_bfly(typename Cx<T>::type* s, int n,
                                           int logw, int pitch, int ns,
                                           const typename Cx<T>::type* tw,
                                           T sg) {
  typedef typename Cx<T>::type C;
  constexpr int NB = (kPerThread + R - 1) / R;
  C v[NB][R];
  const int wmask = (1 << logw) - 1;
  const int m = n / R;
  const int total = m << logw;
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    const int b = threadIdx.x + i * blockDim.x;
    if (b < total) {
      const int j = b >> logw;
      const int c = b & wmask;
      const int k = j % ns;
#pragma unroll
      for (int r = 0; r < R; ++r) v[i][r] = s[(j + r * m) * pitch + c];
      if (ns > 1) {
#pragma unroll
        for (int r = 1; r < R; ++r) {
          C w = tw[k * (R - 1) + r - 1];
          w.y *= sg;
          v[i][r] = cmul(v[i][r], w);
        }
      }
      Butterfly<T, R>::run(v[i], sg);
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    const int b = threadIdx.x + i * blockDim.x;
    if (b < total) {
      const int j = b >> logw;
      const int c = b & wmask;
      const int k = j % ns;
      const int d = (j - k) * R + k;
#pragma unroll
      for (int r = 0; r < R; ++r) s[(d + r * ns) * pitch + c] = v[i][r];
    }
  }
  __syncthreads();
}

// One stage of any radix R, each output summed directly from its R inputs.
template <typename T>
__device__ __forceinline__ void stage_generic(typename Cx<T>::type* s, int n,
                                           int logw, int pitch, int R,
                                           int ns,
                                           const typename Cx<T>::type* tw,
                                           T sg) {
  typedef typename Cx<T>::type C;
  C v[kPerThread];
  const int wmask = (1 << logw) - 1;
  const int m = n / R;
  const int L = ns * R;
  const int total = n << logw;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int e = threadIdx.x + i * blockDim.x;
    if (e < total) {
      const int d = e >> logw;
      const int c = e & wmask;
      const int k = d % ns;
      const int q = (d / ns) % R;
      const int j = (d / L) * ns + k;
      const int step = k + q * ns;
      C acc = cx<T>(T(0), T(0));
      int t = 0;
      for (int r = 0; r < R; ++r) {
        C w = tw[t];
        w.y *= sg;
        const C x = s[(j + r * m) * pitch + c];
        acc.x += x.x * w.x - x.y * w.y;
        acc.y += x.x * w.y + x.y * w.x;
        t += step;
        if (t >= L) t -= L;
      }
      v[i] = acc;
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int e = threadIdx.x + i * blockDim.x;
    if (e < total) s[(e >> logw) * pitch + (e & wmask)] = v[i];
  }
  __syncthreads();
}

// Transform every column of the tile along its n rows.  plan holds nst
// (radix, ns, offset) triples; tw the twiddles of all stages.  MIXED = false
// compiles only the radix-4 and radix-2 stages, for a power-of-two n: with
// the radix-3, radix-5 and generic stages in the same function the register
// allocator spills (ptxas -v), so a kernel is instantiated both ways and
// the host picks the power-of-two one where it can.
template <typename T, bool MIXED>
__device__ void fft_tile(typename Cx<T>::type* s, int n, int logw, int pitch,
                         const int* __restrict__ plan, int nst,
                         const typename Cx<T>::type* __restrict__ tw,
                         bool inverse) {
  const T sg = inverse ? T(-1) : T(1);
  for (int st = 0; st < nst; ++st) {
    const int R = plan[3 * st];
    const int ns = plan[3 * st + 1];
    const typename Cx<T>::type* t = tw + plan[3 * st + 2];
    if (R == 4) {
      stage_bfly<T, 4>(s, n, logw, pitch, ns, t, sg);
    } else if (R == 2) {
      stage_bfly<T, 2>(s, n, logw, pitch, ns, t, sg);
    } else if (MIXED) {
      switch (R) {
        case 3: stage_bfly<T, 3>(s, n, logw, pitch, ns, t, sg); break;
        case 5: stage_bfly<T, 5>(s, n, logw, pitch, ns, t, sg); break;
        default: stage_generic<T>(s, n, logw, pitch, R, ns, t, sg); break;
      }
    }
  }
}

// Copy the twiddles and the plan of a transform into shared memory behind
// the tile (at `end`), so that every stage reads them at shared-memory
// latency rather than one device-memory round trip per stage.  The copies
// are asynchronous (cp.async), so they do not hold up the tile's loads; the
// caller waits for them (__pipeline_wait_prior(0), as gather does) before
// the __syncthreads that publishes the tile.
template <typename C>
__device__ __forceinline__ void stage_tables(C* end, const C* __restrict__ tw,
                                             int ntw,
                                             const int* __restrict__ plan,
                                             int nst, const C** stw,
                                             const int** splan) {
  C* t = end;
  int* p = reinterpret_cast<int*>(end + ntw);
  for (int i = threadIdx.x; i < ntw; i += blockDim.x)
    __pipeline_memcpy_async(t + i, tw + i, sizeof(C));
  for (int i = threadIdx.x; i < 3 * nst; i += blockDim.x)
    __pipeline_memcpy_async(p + i, plan + i, sizeof(int));
  __pipeline_commit();
  *stw = t;
  *splan = p;
}

// Fill the tile: element e in [0, n W) comes from load(e) and goes to row
// e >> logw, column e mod W.  A thread issues all of its loads before it
// stores any of them, so each keeps up to kPerThread loads in flight: a loop
// that stores each value as it arrives waits for device memory once per
// element.  It also waits for the thread's stage_tables copies.
template <typename C, typename F>
__device__ __forceinline__ void gather(C* s, int total, int logw, int pitch,
                                       F load) {
  C v[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int e = threadIdx.x + i * blockDim.x;
    if (e < total) v[i] = load(e);
  }
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int e = threadIdx.x + i * blockDim.x;
    if (e < total) s[(e >> logw) * pitch + (e & ((1 << logw) - 1))] = v[i];
  }
  __pipeline_wait_prior(0);
  __syncthreads();
}

// Multiply element e of the tile by the real factor(e), all of a thread's
// factors loaded before the first product, as in gather.
template <typename C, typename F>
__device__ __forceinline__ void scale_tile(C* s, int total, int logw,
                                           int pitch, F factor) {
  decltype(factor(0)) k[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int e = threadIdx.x + i * blockDim.x;
    if (e < total) k[i] = factor(e);
  }
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int e = threadIdx.x + i * blockDim.x;
    if (e < total) {
      C& z = s[(e >> logw) * pitch + (e & ((1 << logw) - 1))];
      z.x *= k[i];
      z.y *= k[i];
    }
  }
  __syncthreads();
}

inline bool is_pow2(int n) { return n > 0 && (n & (n - 1)) == 0; }

// Host side: the launch geometry of an n x W tile of complex T.
inline int ilog2(int v) {
  int r = 0;
  while ((1 << r) < v) ++r;
  return r;
}

inline int tile_threads(int n, int W) {
  const int need = (n * W + kPerThread - 1) / kPerThread;
  const int t = ((need + 31) / 32) * 32;
  return t < kMaxThreads ? t : kMaxThreads;
}

// The tile, padded rows, then the twiddles and the plan (stage_tables).
template <typename T>
inline size_t tile_smem(int n, int W, int ntw, int nst) {
  return ((size_t)n * (W + 1) + ntw) * sizeof(typename Cx<T>::type) +
         3 * sizeof(int) * nst;
}

// Allow a kernel the dynamic shared memory it asks for above 48 KB.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace fftcore
