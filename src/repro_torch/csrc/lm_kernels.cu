// Hand-written Hopper kernels of the LM serving path
// (repro_torch/kernels/ops.py, called by repro_torch/models/):
//
//   flash_attention_fwd_kernel <- src/repro/kernels/flash_attention.py
//                                 _kernel (:21-54)                      K8
//   rmsnorm_kernel<.., false>  <- src/repro/kernels/rmsnorm.py
//                                 _kernel (:17-22)                      K9
//   rmsnorm_kernel<.., true>   <- same file, _kernel_residual (:25-32)  K9
//   ssm_state_scan_kernel      <- src/repro/kernels/ssm_scan.py
//                                 _kernel (:23-32)                      K10
//
// K8, causal attention over the whole prompt, forward, with GQA and an
// optional tanh softcap.  q is (B, S, H, D) and k/v are (B, S, KVH, D),
// contiguous, read in that layout (the reference transposes to (B*H, S, D)
// first; here each CTA computes its own offsets).  One CTA of 128 threads
// owns 32 query rows of one (b, h): 4 threads per row, each holding an
// interleaved quarter of D of the scaled query and of the f32 accumulator,
// so the 4 threads of a row read 64 neighbouring bytes of a staged key and
// the 8 rows of a warp read the same ones (a broadcast, no bank conflict).
// A score is the 4 partial dots summed by two warp shuffles.  The CTA
// walks the key tiles up to its causal frontier only, staging each tile of
// K and V in shared memory as f32 (64 keys at D <= 128, 32 above), and
// keeps an online softmax (m, l, acc) per row, updated every 16 keys.  The
// Pallas kernel's numerics are kept: q is scaled by 1/sqrt(D) in f32 before
// the dot, softcap * tanh(s / softcap) only when softcap > 0, masked scores
// are -1e30 (not -inf), l is clamped at 1e-20, and query head h reads kv
// head h / (H / KVH), as the reference's _repeat_kv orders them.  Every
// product and sum is f32 on the CUDA cores: no TF32 and no bf16 products,
// so a bf16 input is widened exactly and only the output is rounded.
// Bound: at the serving shape (B=8, S=2048, H=32, KVH=8, D=128, bf16) the
// 2.75e11 causal flops over the tensor cores' 989 TFLOP/s (0.278 ms) bound
// it, not its 335 MB; this kernel does its flops on the CUDA cores and is
// limited by shared-memory reads (one 16-byte load per 4 FMAs), well above
// that bound.  A wgmma/TMA version is later work.
//
// K9, RMSNorm with a (1 + w) scale over the last axis of (rows, d), in f32:
// one CTA of 256 threads per row.  Each thread sums the squares of its
// 4-wide chunks, the CTA reduces them with warp shuffles and one shared
// slot per warp, and a second pass over the row (from L1/L2) writes
// x * (1 / sqrt(mean + eps)) * (1 + w) in x's dtype.  The residual variant
// sums s = x + r in f32, writes s rounded to x's dtype as the new residual
// and normalises the unrounded s, as _kernel_residual does.  Bound by
// device memory: rmsnorm reads x and writes the output (268 MB at
// 16384 x 4096 bf16, 0.080 ms at 3.35 TB/s), the residual variant reads
// two and writes two (0.160 ms).
//
// K10, the exclusive inter-chunk scan of Mamba-2's SSD: for states s
// (nc, B, H, N, P) and decay (nc, B, H), both f32, out[c] = h before chunk
// c, then h = h * decay[c, b, h] + s[c].  Every (b, h, n, p) is a chain of
// its own: one thread per element of B*H*N*P keeps h in a register across
// the nc chunks (the Pallas kernel pins it in VMEM the same way), so
// consecutive threads read and write consecutive addresses and the chunk
// stride is B*H*N*P.  The decay of a thread's (b, h) is one f32 that the
// N*P threads of a head share (an L1 hit).  Bound by device memory: it
// reads s and writes out once (235 MB each at the Zamba2-7B serving shape
// nc 16, B 8, H 112, N = P = 64: 0.140 ms at 3.35 TB/s).  --fmad=false
// keeps h * d + s rounded twice, as the plain version computes it.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC (plain C interface, ctypes).
// --fmad=false keeps every a*b+c of K9 rounded twice, as the plain PyTorch
// version computes it; K8's dot products call fmaf explicitly.

#include <cuda_runtime.h>
#include <stdint.h>

// dtype codes of the C interface (the wrappers' DTYPES)
#define DT_F32 0
#define DT_BF16 1

struct bf16 {  // storage only: the bits of a bfloat16
  uint16_t bits;
};

__device__ __forceinline__ float bf16_lo(uint32_t two) {
  return __uint_as_float(two << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t two) {
  return __uint_as_float(two & 0xffff0000u);
}

// round to nearest even, as torch's .to(torch.bfloat16); NaN stays NaN
__device__ __forceinline__ uint32_t f32_to_bf16_bits(float f) {
  const uint32_t u = __float_as_uint(f);
  if ((u & 0x7fffffffu) > 0x7f800000u) return (u >> 16) | 0x40u;
  return (u + 0x7fffu + ((u >> 16) & 1u)) >> 16;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  return make_float4(bf16_lo(raw.x), bf16_hi(raw.x), bf16_lo(raw.y),
                     bf16_hi(raw.y));
}
__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store4(bf16* p, float4 x) {
  uint2 raw;
  raw.x = f32_to_bf16_bits(x.x) | (f32_to_bf16_bits(x.y) << 16);
  raw.y = f32_to_bf16_bits(x.z) | (f32_to_bf16_bits(x.w) << 16);
  *reinterpret_cast<uint2*>(p) = raw;
}

// ---------------------------------------------------------------------------
// K8
// ---------------------------------------------------------------------------

#define FA_BQ 32                      // query rows per CTA
#define FA_TPR 4                      // threads per query row
#define FA_THREADS (FA_BQ * FA_TPR)   // 128
#define FA_KC 16                      // keys per online-softmax update

template <int D>
struct FaTile {
  static constexpr int BK = D > 128 ? 32 : 64;   // keys staged per tile
  static constexpr int NC = D / (4 * FA_TPR);    // float4 chunks per thread
  static constexpr int SMEM = 2 * BK * D * 4;    // K and V tiles, f32
};

template <typename T, int D>
__global__ void __launch_bounds__(FA_THREADS)
    flash_attention_fwd_kernel(const T* __restrict__ q,
                               const T* __restrict__ k,
                               const T* __restrict__ v, T* __restrict__ o,
                               int S, int H, int KVH, float scale,
                               float softcap) {
  constexpr int BK = FaTile<D>::BK;
  constexpr int NC = FaTile<D>::NC;
  constexpr int D4 = D / 4;
  extern __shared__ float4 fa_smem[];
  float4* ks = fa_smem;             // [BK][D4]
  float4* vs = fa_smem + BK * D4;   // [BK][D4]

  const int tid = threadIdx.x;
  const int row = tid / FA_TPR;
  const int part = tid % FA_TPR;
  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest rows first
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int kvh = h / (H / KVH);
  const int qpos = qt * FA_BQ + row;
  const bool live = qpos < S;
  const long long q_off =
      (static_cast<long long>(b) * S + (live ? qpos : S - 1)) * H * D +
      static_cast<long long>(h) * D;

  float4 qr[NC], acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const float4 x = load4(q + q_off + 4 * (part + FA_TPR * c));
    qr[c] = make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
    acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = -1e30f, l = 0.f;

  const int q_end = min(qt * FA_BQ + FA_BQ, S);  // one past the last row
  const int n_tiles = (q_end + BK - 1) / BK;     // the causal frontier
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < BK * D4; i += FA_THREADS) {
      const int kp = k0 + i / D4;
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f), vv = kk;
      if (kp < S) {
        const long long off =
            (static_cast<long long>(b) * S + kp) * KVH * D +
            static_cast<long long>(kvh) * D + 4 * (i % D4);
        kk = load4(k + off);
        vv = load4(v + off);
      }
      ks[i] = kk;
      vs[i] = vv;
    }
    __syncthreads();
    const int n_keys = min(BK, q_end - k0);
    for (int j0 = 0; j0 < n_keys; j0 += FA_KC) {
      float s[FA_KC];
      float m_new = m;
#pragma unroll
      for (int jj = 0; jj < FA_KC; ++jj) {
        const float4* kr = ks + (j0 + jj) * D4;
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 kc = kr[part + FA_TPR * c];
          dot = fmaf(qr[c].x, kc.x, dot);
          dot = fmaf(qr[c].y, kc.y, dot);
          dot = fmaf(qr[c].z, kc.z, dot);
          dot = fmaf(qr[c].w, kc.w, dot);
        }
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        dot += __shfl_xor_sync(0xffffffffu, dot, 2);
        if (softcap > 0.f) dot = softcap * tanhf(dot / softcap);
        // keys past the query (and past S, which are past every query of
        // a live row) are masked
        s[jj] = (k0 + j0 + jj <= qpos) ? dot : -1e30f;
        m_new = fmaxf(m_new, s[jj]);
      }
      const float alpha = expf(m - m_new);
      float p_sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < FA_KC; ++jj) {
        s[jj] = expf(s[jj] - m_new);
        p_sum += s[jj];
      }
      l = l * alpha + p_sum;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        acc[c].x *= alpha;
        acc[c].y *= alpha;
        acc[c].z *= alpha;
        acc[c].w *= alpha;
      }
#pragma unroll
      for (int jj = 0; jj < FA_KC; ++jj) {
        const float4* vr = vs + (j0 + jj) * D4;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 vc = vr[part + FA_TPR * c];
          acc[c].x = fmaf(s[jj], vc.x, acc[c].x);
          acc[c].y = fmaf(s[jj], vc.y, acc[c].y);
          acc[c].z = fmaf(s[jj], vc.z, acc[c].z);
          acc[c].w = fmaf(s[jj], vc.w, acc[c].w);
        }
      }
      m = m_new;
    }
  }
  if (!live) return;
  const float den = fmaxf(l, 1e-20f);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    store4(o + q_off + 4 * (part + FA_TPR * c),
           make_float4(acc[c].x / den, acc[c].y / den, acc[c].z / den,
                       acc[c].w / den));
  }
}

template <typename T, int D>
static int launch_fa(const void* q, const void* k, const void* v, void* o,
                     int B, int S, int H, int KVH, float softcap,
                     cudaStream_t stream) {
  constexpr int smem = FaTile<D>::SMEM;
  auto kernel = flash_attention_fwd_kernel<T, D>;
  // above 48 KB only as dynamic shared memory, after this opt-in
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + FA_BQ - 1) / FA_BQ, B * H);
  kernel<<<grid, FA_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, KVH,
      1.0f / sqrtf(static_cast<float>(D)), softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int dispatch_fa(const void* q, const void* k, const void* v, void* o,
                       int B, int S, int H, int KVH, int D, float softcap,
                       cudaStream_t stream) {
  switch (D) {
    case 16: return launch_fa<T, 16>(q, k, v, o, B, S, H, KVH, softcap, stream);
    case 32: return launch_fa<T, 32>(q, k, v, o, B, S, H, KVH, softcap, stream);
    case 64: return launch_fa<T, 64>(q, k, v, o, B, S, H, KVH, softcap, stream);
    case 96: return launch_fa<T, 96>(q, k, v, o, B, S, H, KVH, softcap, stream);
    case 112:
      return launch_fa<T, 112>(q, k, v, o, B, S, H, KVH, softcap, stream);
    case 128:
      return launch_fa<T, 128>(q, k, v, o, B, S, H, KVH, softcap, stream);
    case 256:
      return launch_fa<T, 256>(q, k, v, o, B, S, H, KVH, softcap, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// K9
// ---------------------------------------------------------------------------

#define RN_THREADS 256

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

template <typename T, typename W, bool kResidual>
__global__ void __launch_bounds__(RN_THREADS)
    rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ r,
                   const W* __restrict__ w, T* __restrict__ o,
                   T* __restrict__ ro, int d, float eps) {
  __shared__ float partial[RN_THREADS / 32];
  const long long base = static_cast<long long>(blockIdx.x) * d;
  float ss = 0.f;
  for (int i = 4 * threadIdx.x; i < d; i += 4 * RN_THREADS) {
    float4 s = load4(x + base + i);
    if (kResidual) {
      s = add4(s, load4(r + base + i));
      store4(ro + base + i, s);
    }
    ss += s.x * s.x;
    ss += s.y * s.y;
    ss += s.z * s.z;
    ss += s.w * s.w;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if (threadIdx.x % 32 == 0) partial[threadIdx.x / 32] = ss;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < RN_THREADS / 32; ++i) total += partial[i];
  const float inv = 1.0f / sqrtf(total / static_cast<float>(d) + eps);
  for (int i = 4 * threadIdx.x; i < d; i += 4 * RN_THREADS) {
    float4 s = load4(x + base + i);
    if (kResidual) s = add4(s, load4(r + base + i));
    const float4 g = load4(w + i);
    store4(o + base + i,
           make_float4(s.x * inv * (1.0f + g.x), s.y * inv * (1.0f + g.y),
                       s.z * inv * (1.0f + g.z), s.w * inv * (1.0f + g.w)));
  }
}

template <typename T, typename W, bool kResidual>
static int launch_rn(const void* x, const void* r, const void* w, void* o,
                     void* ro, long long rows, int d, float eps,
                     cudaStream_t stream) {
  rmsnorm_kernel<T, W, kResidual><<<static_cast<unsigned>(rows), RN_THREADS,
                                    0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(r),
      static_cast<const W*>(w), static_cast<T*>(o), static_cast<T*>(ro), d,
      eps);
  return static_cast<int>(cudaGetLastError());
}

template <bool kResidual>
static int dispatch_rn(const void* x, const void* r, const void* w, void* o,
                       void* ro, int dtype, int w_dtype, long long rows,
                       int d, float eps, cudaStream_t stream) {
  if (dtype == DT_F32 && w_dtype == DT_F32)
    return launch_rn<float, float, kResidual>(x, r, w, o, ro, rows, d, eps,
                                              stream);
  if (dtype == DT_F32 && w_dtype == DT_BF16)
    return launch_rn<float, bf16, kResidual>(x, r, w, o, ro, rows, d, eps,
                                             stream);
  if (dtype == DT_BF16 && w_dtype == DT_F32)
    return launch_rn<bf16, float, kResidual>(x, r, w, o, ro, rows, d, eps,
                                             stream);
  if (dtype == DT_BF16 && w_dtype == DT_BF16)
    return launch_rn<bf16, bf16, kResidual>(x, r, w, o, ro, rows, d, eps,
                                            stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// K10
// ---------------------------------------------------------------------------

#define SCAN_THREADS 256

__global__ void __launch_bounds__(SCAN_THREADS)
    ssm_state_scan_kernel(const float* __restrict__ s,
                          const float* __restrict__ decay,
                          float* __restrict__ out, int nc, long long n,
                          long long bh, int np) {
  const long long i =
      static_cast<long long>(blockIdx.x) * SCAN_THREADS + threadIdx.x;
  if (i >= n) return;
  const long long head = i / np;  // (b, h) of this element
  float h = 0.f;
  for (int c = 0; c < nc; ++c) {
    const long long off = c * n + i;
    const float sc = s[off];
    const float dc = decay[c * bh + head];
    out[off] = h;
    h = h * dc + sc;
  }
}

extern "C" {

// q (B, S, H, D), k/v (B, S, KVH, D), o like q; contiguous, 16-byte
// aligned, D in {16, 32, 64, 96, 112, 128, 256}, H % KVH == 0.
int launch_flash_attention(const void* q, const void* k, const void* v,
                           void* o, int dtype, int B, int S, int H, int KVH,
                           int D, float softcap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    return dispatch_fa<float>(q, k, v, o, B, S, H, KVH, D, softcap, st);
  if (dtype == DT_BF16)
    return dispatch_fa<bf16>(q, k, v, o, B, S, H, KVH, D, softcap, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// x, o (rows, d) contiguous, d % 4 == 0; w (d,)
int launch_rmsnorm(const void* x, const void* w, void* o, int dtype,
                   int w_dtype, long long rows, int d, float eps,
                   void* stream) {
  return dispatch_rn<false>(x, nullptr, w, o, nullptr, dtype, w_dtype, rows,
                            d, eps, static_cast<cudaStream_t>(stream));
}

// x, r, o, ro (rows, d) contiguous, d % 4 == 0; w (d,)
int launch_rmsnorm_residual(const void* x, const void* r, const void* w,
                            void* o, void* ro, int dtype, int w_dtype,
                            long long rows, int d, float eps, void* stream) {
  return dispatch_rn<true>(x, r, w, o, ro, dtype, w_dtype, rows, d, eps,
                           static_cast<cudaStream_t>(stream));
}

// states, out (nc, B, H, N, P) and decay (nc, B, H), f32 and contiguous;
// n = B*H*N*P, bh = B*H, np = N*P
int launch_ssm_state_scan(const void* states, const void* decay, void* out,
                          int nc, long long n, long long bh, int np,
                          void* stream) {
  if (n == 0) return 0;
  const long long blocks = (n + SCAN_THREADS - 1) / SCAN_THREADS;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  ssm_state_scan_kernel<<<static_cast<unsigned>(blocks), SCAN_THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(states), static_cast<const float*>(decay),
      static_cast<float*>(out), nc, n, bh, np);
  return static_cast<int>(cudaGetLastError());
}

const char* lm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
