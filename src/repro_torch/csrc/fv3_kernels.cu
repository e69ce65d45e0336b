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
// keeps the carries in vector registers.  It reads four fields and writes
// one, about 10 flops a point (two IEEE divisions): bound by device
// memory, 5 words a point.  Here one thread owns one column, neighbouring
// threads neighbouring i, so every load and store of a level coalesces, and
// a CTA is one warp, K6_TILE columns:
// * cp and dp of every level stay in shared memory, [level][column], so
//   the back substitution reads them there and x is written once: 5 words
//   a point, where keeping cp in a scratch and dp in x moved 9;
// * the levels' loads run ahead of the division chain: a ring of K6_RING
//   levels of a, b, c, d in shared memory, each level one cp.async commit
//   group issued K6_RING - 1 levels before the march reaches it, so a
//   level's divisions wait on no device memory;
// * no barrier: each thread copies, waits for and reads its own column;
// * a warp a CTA: the columns an SM holds are bound by its shared memory,
//   and the finest tile packs the most of them (at 80 levels in f32, 9
//   CTAs of 24 KB, 288 columns, where tiles of 128 held 256), with the
//   finest tail.
// A CTA may take 227 KB: 2 nk + 4 K6_RING values a column fit up to nk 892
// in f32 and 438 in f64 (kernels/tridiag.py, ``plan``); past that the
// levels >= `levels` keep cp in the scratch `cpg` ([k - levels][column])
// and dp in x (9 words a point there).  Templated on float and
// double: the reference sweeps both; each division is the IEEE one
// (--fmad=false), in the plain version's order.
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

#define BLOCK 256  // K7: threads a CTA

static unsigned int blocks_for(long long n) {
  return static_cast<unsigned int>((n + BLOCK - 1) / BLOCK);
}

// cp.async of one T (4 or 8 bytes) into shared memory, in the thread's
// current commit group
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "n"(sizeof(T))
               : "memory");
}

#define K6_RING 8   // levels of a, b, c, d in flight a thread (a power of 2)
#define K6_TILE 32  // columns (threads) a CTA

// K6: one thread per column of nk levels; plane = nj * ni.  Shared memory,
// each [..][K6_TILE]: cp [levels], dp [levels], the ring [K6_RING][4].
template <typename T>
__global__ void __launch_bounds__(K6_TILE)
    tridiag_kernel(const T* __restrict__ a, const T* __restrict__ b,
                   const T* __restrict__ c, const T* __restrict__ d,
                   T* __restrict__ x, T* __restrict__ cpg, int nk,
                   long long plane, int levels) {
  extern __shared__ __align__(16) unsigned char k6_smem[];
  constexpr int tile = K6_TILE;
  const long long col =
      static_cast<long long>(blockIdx.x) * tile + threadIdx.x;
  if (col >= plane) return;
  T* const cps = reinterpret_cast<T*>(k6_smem) + threadIdx.x;
  T* const dps = cps + static_cast<size_t>(levels) * tile;
  T* const ring = dps + static_cast<size_t>(levels) * tile;
  const T* const src[4] = {a + col, b + col, c + col, d + col};
  // level k's a, b, c, d into its ring slot, as one commit group (an empty
  // one past the last level)
  auto issue = [&](int k) {
    if (k < nk) {
      T* slot = ring + (k & (K6_RING - 1)) * 4 * tile;
#pragma unroll
      for (int f = 0; f < 4; ++f)
        copy_async(slot + f * tile, src[f] + k * plane);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  for (int k = 0; k < K6_RING - 1; ++k) issue(k);
  T cp_prev = 0, dp_prev = 0;
  for (int k = 0; k < nk; ++k) {
    // level k's group is done; the K6_RING - 2 after it may still run
    asm volatile("cp.async.wait_group %0;" ::"n"(K6_RING - 2) : "memory");
    const T* slot = ring + (k & (K6_RING - 1)) * 4 * tile;
    const T ak = slot[0], bk = slot[tile], ck = slot[2 * tile],
            dk = slot[3 * tile];
    issue(k + K6_RING - 1);  // into the slot level k - 1 left
    T cpk, dpk;
    if (k == 0) {
      cpk = ck / bk;
      dpk = dk / bk;
    } else {
      const T denom = bk - ak * cp_prev;
      cpk = ck / denom;
      dpk = (dk - ak * dp_prev) / denom;
    }
    if (k < levels) {
      cps[k * tile] = cpk;
      dps[k * tile] = dpk;
    } else {
      cpg[(k - levels) * plane + col] = cpk;
      x[k * plane + col] = dpk;
    }
    cp_prev = cpk;
    dp_prev = dpk;
  }
  T x_next = dp_prev;
  x[(nk - 1) * plane + col] = x_next;
  for (int k = nk - 2; k >= 0; --k) {
    const T cpk = k < levels ? cps[k * tile] : cpg[(k - levels) * plane + col];
    const T dpk = k < levels ? dps[k * tile] : x[k * plane + col];
    x_next = dpk - cpk * x_next;
    x[k * plane + col] = x_next;
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

// K6: cp and dp of levels [0, levels) in shared memory, the deeper ones in
// ``cpg`` and x.
template <typename T>
static int launch_tridiag(const T* a, const T* b, const T* c, const T* d,
                          T* x, T* cpg, int nk, long long plane, int levels,
                          void* stream) {
  const size_t bytes =
      (2 * static_cast<size_t>(levels) + 4 * K6_RING) * K6_TILE * sizeof(T);
  if (nk < 1 || levels < 0 || levels > nk ||
      (levels < nk && cpg == nullptr) || bytes > 227 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bytes > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        tridiag_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const unsigned int blocks =
      static_cast<unsigned int>((plane + K6_TILE - 1) / K6_TILE);
  tridiag_kernel<T><<<blocks, K6_TILE, bytes,
                      static_cast<cudaStream_t>(stream)>>>(
      a, b, c, d, x, cpg, nk, plane, levels);
  return static_cast<int>(cudaGetLastError());
}

extern "C" {

int launch_tridiag_f32(const float* a, const float* b, const float* c,
                       const float* d, float* x, float* cpg, int nk,
                       long long plane, int levels, void* stream) {
  return launch_tridiag(a, b, c, d, x, cpg, nk, plane, levels, stream);
}

int launch_tridiag_f64(const double* a, const double* b, const double* c,
                       const double* d, double* x, double* cpg, int nk,
                       long long plane, int levels, void* stream) {
  return launch_tridiag(a, b, c, d, x, cpg, nk, plane, levels, stream);
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
