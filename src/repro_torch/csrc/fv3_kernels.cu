// Hand-written Hopper kernels for the two standalone FV3 hot spots of the
// op entry point (repro_torch/kernels/ops.py):
//
//   tridiag_kernel   <- src/repro/kernels/tridiag.py  _kernel (:22-46)   K6
//   fvt_flux_kernel  <- src/repro/kernels/fvt_flux.py _kernel (:21-53)   K7
//
// Both take (K, J, I) arrays with I contiguous, as the reference does.
//
// K6, a batched Thomas solve of tridiag(a, b, c) x = d along K for every
// (j, i) column.  The Pallas kernel holds a (nk, bj, ni) block in VMEM and
// keeps the carries in vector registers.  Here one thread owns one column:
// the forward elimination keeps cp/dp of the previous level in registers,
// stages cp in a scratch buffer and dp in x, and the back substitution
// walks the column upward through both.  Neighbouring threads take
// neighbouring i, so every load and store of a level coalesces.  It reads
// four fields and writes one (the scratch is written and read again, which
// the bound does not count), about 10 flops a point: bound by device
// memory, 5 * 4 bytes a point in f32.  A C192 six-tile interior stack has
// 221 184 columns, 864 blocks of 256 threads, enough to fill 132 SMs.
// Templated on float and double: the reference sweeps both.
//
// K7, the fused PPM x-flux of al_x -> fx_ppm.  One thread per (k, j, i)
// point of the padded (K, J+2h, I+2h) array.  It recomputes the
// 4th-order interface values at i and i+1 (and at i-1 for the upwind
// neighbour) instead of staging them, picks the upwind side by the sign
// of cx, clips to the neighbours' min/max and writes c*f on the interior
// i and 0 on the halo i.  It reads q at i-3 .. i+2, so the caller
// requires halo >= 3.  The six q loads of a thread overlap its
// neighbours', so they come from L1; the kernel reads two fields and
// writes one, ~35 flops a point: bound by device memory, 12 bytes a point.
// f32, as the reference.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC (plain C interface, ctypes).
// --fmad=false keeps every a*b+c rounded twice, as the plain PyTorch
// version computes it.

#include <cuda_runtime.h>
#include <stdint.h>

#define BLOCK 256

static unsigned int blocks_for(long long n) {
  return static_cast<unsigned int>((n + BLOCK - 1) / BLOCK);
}

// K6: one thread per column of nk levels; plane = nj * ni.
template <typename T>
__global__ void __launch_bounds__(BLOCK)
    tridiag_kernel(const T* __restrict__ a, const T* __restrict__ b,
                   const T* __restrict__ c, const T* __restrict__ d,
                   T* __restrict__ x, T* __restrict__ cp, int nk,
                   long long plane) {
  const long long col =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (col >= plane) return;
  T cp_prev = c[col] / b[col];
  T dp_prev = d[col] / b[col];
  cp[col] = cp_prev;
  x[col] = dp_prev;
  for (int k = 1; k < nk; ++k) {
    const long long o = k * plane + col;
    const T ak = a[o];
    const T denom = b[o] - ak * cp_prev;
    const T cpk = c[o] / denom;
    const T dpk = (d[o] - ak * dp_prev) / denom;
    cp[o] = cpk;
    x[o] = dpk;
    cp_prev = cpk;
    dp_prev = dpk;
  }
  T x_next = dp_prev;
  for (int k = nk - 2; k >= 0; --k) {
    const long long o = k * plane + col;
    x_next = x[o] - cp[o] * x_next;
    x[o] = x_next;
  }
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? (a + b) : fminf(a, b);
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? (a + b) : fmaxf(a, b);
}

// K7: one thread per (k, j, i) of the padded array; ip = ni + 2 * halo.
__global__ void __launch_bounds__(BLOCK)
    fvt_flux_kernel(const float* __restrict__ q, const float* __restrict__ cx,
                    float* __restrict__ fx, long long n, int ip, int halo) {
  const long long g =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (g >= n) return;
  const int i = static_cast<int>(g % ip);
  if (i < halo || i >= ip - halo) {
    fx[g] = 0.f;
    return;
  }
  const float* r = q + g;  // r[di] = q at i + di on this row
  const float c7 = static_cast<float>(7.0 / 12.0);
  const float c1 = static_cast<float>(1.0 / 12.0);
  // al(di): the interface value between i+di-1 and i+di
  const float al0 = c7 * (r[-1] + r[0]) - c1 * (r[-2] + r[1]);
  const float al1 = c7 * (r[0] + r[1]) - c1 * (r[-1] + r[2]);
  const float alm1 = c7 * (r[-2] + r[-1]) - c1 * (r[-3] + r[0]);
  const float q0 = r[0], qm1 = r[-1];
  const float bl = al0 - q0;
  const float br = al1 - q0;
  const float b0 = bl + br;
  const float blm1 = alm1 - qm1;
  const float brm1 = al0 - qm1;
  const float b0m1 = blm1 + brm1;
  const float c = cx[g];
  float f = c > 0.f ? qm1 + (1.f - c) * (brm1 - c * b0m1)
                    : q0 - (1.f + c) * (bl + c * b0);
  // clip(f, min, max) as max-then-min, NaN-propagating like the reference
  f = nan_min(nan_max(f, nan_min(qm1, q0)), nan_max(qm1, q0));
  fx[g] = c * f;
}

extern "C" {

int launch_tridiag_f32(const float* a, const float* b, const float* c,
                       const float* d, float* x, float* cp, int nk,
                       long long plane, void* stream) {
  tridiag_kernel<float><<<blocks_for(plane), BLOCK, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      a, b, c, d, x, cp, nk, plane);
  return static_cast<int>(cudaGetLastError());
}

int launch_tridiag_f64(const double* a, const double* b, const double* c,
                       const double* d, double* x, double* cp, int nk,
                       long long plane, void* stream) {
  tridiag_kernel<double><<<blocks_for(plane), BLOCK, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      a, b, c, d, x, cp, nk, plane);
  return static_cast<int>(cudaGetLastError());
}

int launch_fvt_flux(const float* q, const float* cx, float* fx, int nk,
                    int jp, int ip, int halo, void* stream) {
  const long long n = static_cast<long long>(nk) * jp * ip;
  fvt_flux_kernel<<<blocks_for(n), BLOCK, 0,
                    static_cast<cudaStream_t>(stream)>>>(q, cx, fx, n, ip,
                                                         halo);
  return static_cast<int>(cudaGetLastError());
}

const char* fv3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
