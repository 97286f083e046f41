// Damped real-space ion-ion pair sum for Hopper (sm_90a), in float64.
//
// Replaces no TPU kernel: the JAX package sums the pairs with XLA, image
// chunk by image chunk (professad_tpu/models/ions.py::ion_interaction_sum),
// and so did the port until a 2048-ion cell needed it.  At that size the sum
// runs over 2048^2 pairs times ~1900 periodic images (8.1e9 candidate terms,
// ~3.8e9 within the cutoff), and autograd of the chunked torch form keeps
// every chunk's graph (~650 GB).  This kernel computes the energy, the
// neighbour charges and, on request, the coordinate and cell gradients in
// one pass, holding nothing per pair.
//
// What it computes, for ions i, j, image shifts b (lattice units s_b, their
// Cartesian offsets t_b = s_b h given) and d = R_j + t_b - R_i, r = |d|,
// over the pairs with 1e-12 < r < rc:
//   e_part[y][i]    = sum_{j, b in block row y} Z_i Z_j erfc(r / rd) / r
//   q_part[y][i]    = sum_{j, b in block row y} Z_j
//   g_part[y][i][:] = sum_{j != i, b in block row y} f d
//   w_part[x][b][:] = sum_{i in block column x, j} f d
// with f = e'(r) / r of the pair term e(r) = Z_i Z_j erfc(r / rd) / r.  The
// caller sums the partials (no atomics, so the result does not depend on the
// order blocks run in): E = 1/2 sum e, Q = sum q, dE/dh = 1/2 sum_b s_b (x)
// w_b, and dE/dR_i = -1/2 (sum g + sum g'), g' the g of a launch over the
// negated table (the j ends of the pairs); for a table that holds -s_b beside
// every s_b, g' = g and one launch does.
//
// Layout: a block of kThreads threads holds kThreads ions i (one a thread)
// and a run of `sb` consecutive shifts; it walks every j in tiles of
// kThreads ions staged in shared memory, read by all threads at once
// (broadcast).  Grid: (ceil(n / kThreads), ceil(S / sb)).
//
// What bounds it on this card: FP64 arithmetic.  A candidate term costs ~8
// operations (the distance and the cutoff test); a term inside the cutoff
// adds a square root, a reciprocal, erfc and, with gradients, exp: ~60-120
// FP64 operations.  The inputs are a few hundred kilobytes, so memory plays
// no part.  The design keeps every term in registers, branches on the
// cutoff so that terms outside it cost only their test, and reduces the
// cell gradient per shift in the block (warp shuffles) rather than per
// pair.
//
// C interface (loaded with ctypes): ion_pair_sum launches one kernel on the
// given stream and returns the launch's CUDA error, or 0.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

template <bool GRAD>
__global__ void __launch_bounds__(kThreads)
ion_pair_sum_kernel(const double* __restrict__ pos,
                    const double* __restrict__ z,
                    const double* __restrict__ tvec, int n, int S, int sb,
                    double rc, double rc2, double inv_rd, double c_exp,
                    double* __restrict__ e_part, double* __restrict__ q_part,
                    double* __restrict__ g_part,
                    double* __restrict__ w_part) {
  __shared__ double sx[kThreads], sy[kThreads], sz[kThreads], sq[kThreads];
  __shared__ double red[3][kWarps];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool active = i < n;
  const double xi = active ? pos[3 * i] : 0.0;
  const double yi = active ? pos[3 * i + 1] : 0.0;
  const double zi_ = active ? pos[3 * i + 2] : 0.0;
  const double qi = active ? z[i] : 0.0;
  double e = 0.0, q = 0.0, gx = 0.0, gy = 0.0, gz = 0.0;
  const int b0 = blockIdx.y * sb;
  const int b1 = min(b0 + sb, S);
  for (int b = b0; b < b1; ++b) {
    // d = R_j - (R_i - t_b)
    const double px = xi - tvec[3 * b];
    const double py = yi - tvec[3 * b + 1];
    const double pz = zi_ - tvec[3 * b + 2];
    double wx = 0.0, wy = 0.0, wz = 0.0;
    for (int j0 = 0; j0 < n; j0 += kThreads) {
      const int nj = min(kThreads, n - j0);
      __syncthreads();
      if (threadIdx.x < nj) {
        const int j = j0 + threadIdx.x;
        sx[threadIdx.x] = pos[3 * j];
        sy[threadIdx.x] = pos[3 * j + 1];
        sz[threadIdx.x] = pos[3 * j + 2];
        sq[threadIdx.x] = z[j];
      }
      __syncthreads();
      if (!active) continue;
      for (int k = 0; k < nj; ++k) {
        const double dx = sx[k] - px;
        const double dy = sy[k] - py;
        const double dz = sz[k] - pz;
        const double r2 = dx * dx + dy * dy + dz * dz;
        if (r2 >= rc2) continue;
        const double r = sqrt(r2);
        if (!(r < rc && r > 1e-12)) continue;
        const double rinv = 1.0 / r;
        const double x = r * inv_rd;
        const double zz = qi * sq[k];
        const double ep = zz * erfc(x) * rinv;
        e += ep;
        q += sq[k];
        if (GRAD) {
          const double f = -(zz * c_exp * exp(-x * x) + ep) * rinv * rinv;
          wx += f * dx;
          wy += f * dy;
          wz += f * dz;
          if (j0 + k != i) {
            gx += f * dx;
            gy += f * dy;
            gz += f * dz;
          }
        }
      }
    }
    if (GRAD) {
      // the block's share of shift b's cell-gradient row
      wx = warp_sum(wx);
      wy = warp_sum(wy);
      wz = warp_sum(wz);
      const int warp = threadIdx.x >> 5;
      if ((threadIdx.x & 31) == 0) {
        red[0][warp] = wx;
        red[1][warp] = wy;
        red[2][warp] = wz;
      }
      __syncthreads();
      if (threadIdx.x < 3) {
        double s = 0.0;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += red[threadIdx.x][w];
        w_part[((long long)blockIdx.x * S + b) * 3 + threadIdx.x] = s;
      }
    }
  }
  if (active) {
    const long long o = (long long)blockIdx.y * n + i;
    e_part[o] = e;
    q_part[o] = q;
    if (GRAD) {
      g_part[3 * o] = gx;
      g_part[3 * o + 1] = gy;
      g_part[3 * o + 2] = gz;
    }
  }
}

}  // namespace

extern "C" int ion_pair_threads() { return kThreads; }

extern "C" int ion_pair_sum(const double* pos, const double* z,
                            const double* tvec, int n, int S, int sb,
                            double rc, double rc2, double inv_rd,
                            double c_exp, double* e_part, double* q_part,
                            double* g_part, double* w_part, int grad,
                            void* stream) {
  const dim3 grid((n + kThreads - 1) / kThreads, (S + sb - 1) / sb);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (grad) {
    ion_pair_sum_kernel<true><<<grid, kThreads, 0, st>>>(
        pos, z, tvec, n, S, sb, rc, rc2, inv_rd, c_exp, e_part, q_part,
        g_part, w_part);
  } else {
    ion_pair_sum_kernel<false><<<grid, kThreads, 0, st>>>(
        pos, z, tvec, n, S, sb, rc, rc2, inv_rd, c_exp, e_part, q_part,
        g_part, w_part);
  }
  return static_cast<int>(cudaGetLastError());
}
