// Hand-written Hopper kernels for the stencil IR at opt level 0.
//
// One source serves every stencil of the FV3-lite step: the kernels do not
// contain any stencil, they interpret it.  The Python encoder
// (repro_torch/core/backend/cuda.py) turns each IR statement into a small
// postfix program of int32 ops plus a float32 constant table; a launch gets
// that program, the field table (pointer and K extent per slot), the scalar
// parameters and the geometry of its iteration space.
//
// Three kernels replace the three Pallas kernels of the reference's opt-0
// path (src/repro/core/backend/lowering_pallas.py), and their member axis
// replaces the reference's member grid axis:
//
//   stencil_parallel_kernel  <- _horizontal_kernel (:350)   K1
//   stencil_column_kernel    <- _vertical_kernel   (:486)   K2
//   march_search (device fn) <- _march_search      (:99)    K3
//   nmember/mchunk/mstride   <- _member_index_map,          K5
//                               _member_specs (:207-229)
//
// What bounds them on an H100, and what the design does about it:
//
// * K1 runs one thread per (tile, k, j, i) point of ONE statement's write
//   window.  A stencil statement reads a handful of f32 words per point and
//   writes one, so its floor is device-memory bandwidth (3.35 TB/s); the
//   interpreter adds decode work per op (a switch over the opcode, a stack
//   in local memory) which at opt 0 makes it bound by instruction issue
//   instead.  Neighbouring threads take neighbouring i, so every LOAD and
//   the store coalesce; the program, constants and field table are staged
//   in shared memory once per block, so decoding reads no device memory.
//   Pallas holds the whole IJ plane in one block and runs a stencil's
//   statements in order inside it; blocks of a CUDA grid run in no order,
//   so the wrapper launches K1 once per statement and the launch boundary
//   orders the statements.
// * K2 runs one thread per (tile, j, i) column and marches k over [lo, hi)
//   forward or backward, evaluating the computation's statements in order
//   at each level and re-reading earlier levels from memory (opt 0's
//   memory-backed carry, as the reference's jnp oracle).  Columns are
//   independent (the encoder refuses horizontal-offset reads of fields the
//   computation writes), so no synchronisation is needed.  It is bound by
//   the sequential K chain per thread and by occupancy: a C192 tile set has
//   6*204*204 columns, about 1900 warps over 132 SMs.
// * K3 is the `index_search` level search: one march over the source
//   layers of the coordinate column, keeping the last layer whose lower
//   coordinate does not exceed the target.  It tracks the layer index and
//   loads the at_found values once at the end, which selects the same
//   values as the reference's select-per-layer accumulation.  O(nk) loads
//   per point; the column stays in L1/L2 for the neighbouring k threads.
// * K5, the ensemble member axis.  Pallas puts members on the outermost
//   sequential grid axis, one member (or one C-member chunk) per step.
//   Here a launch covers nmember members: K1 runs one thread per (member
//   chunk, tile, k, j, i) and K2 one per (member chunk, tile, j, i)
//   column, and each thread loops over the mchunk members of its chunk
//   (mchunk = 1 under "grid", C under "vmap:C,grid"); K2 runs the march
//   again from lo for each member, so the carry resets per member.  A
//   slot's member offset is m * mstride[slot] in 64 bits; mstride is 0 for
//   a field broadcast across members (the metric terms), so an expanded
//   tensor reaches the kernel without M copies.  The launch count of a
//   step does not change with M.  The work per member is K1/K2's, so the
//   bound and the cost scale with M; a chunk's members each decode the
//   program again (sharing that decode is later work).  Both kernels are
//   templated on kMembers: a launch over one member (the sequential step)
//   takes the instance without the member offset and the chunk loop, so
//   the member axis costs that path nothing.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC (plain C interface, ctypes).
// --fmad=false keeps every a*b+c rounded twice, as the plain PyTorch
// version computes it, so results stay within a few ulp of it.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_SLOTS 32
#define MAX_PARAMS 16
#define PROG_MAX 1024
#define CONST_MAX 256
#define STACK_MAX 16
#define FOUND_MAX 8
#define REC_INTS 9
#define BLOCK 256

// opcodes — keep in sync with cuda.py
enum {
  OP_LOAD = 1,    // slot di dj dk
  OP_CONST = 2,   // index into the constant table
  OP_PARAM = 3,   // index into the parameter array
  OP_FOUND = 4,   // index of an at_found value of the enclosing search
  OP_SEARCH = 5,  // coord lo hi nf (slot di dj dk)*nf ; pops the target
  OP_NEG = 10, OP_SQRT, OP_ABS, OP_EXP, OP_LOG, OP_SIGN, OP_FLOOR,
  OP_ADD = 20, OP_SUB, OP_MUL, OP_DIV, OP_LT, OP_LE, OP_GT, OP_GE, OP_EQ,
  OP_NE, OP_MIN, OP_MAX, OP_POW,
  OP_WHERE = 40   // pops b, a, cond
};

// One launch.  The program buffer starts with the statement records:
//   prog[0] = n_stmts; then per statement REC_INTS ints:
//   target klo khi j0 j1 i0 i1 op_begin op_end
// (j/i bounds in padded coordinates, the write window cut to the region).
struct LaunchArgs {
  float* ptr[MAX_SLOTS];
  long long mstride[MAX_SLOTS];  // elements between members; 0: broadcast
  int kext[MAX_SLOTS];
  float params[MAX_PARAMS];
  const int* prog;
  const float* consts;
  int n_prog, n_consts, n_slots, n_params;
  int ntile, jp, ip;
  int klo, khi;            // K1: the statement's interval
  int j0, j1, i0, i1;      // K1: statement box; K2: write window
  int lo, hi, forward;     // K2: the march
  int nmember, mchunk;     // K5: members, and members per thread
};

struct Shared {
  float* ptr[MAX_SLOTS];
  long long mstride[MAX_SLOTS];
  int kext[MAX_SLOTS];
  float params[MAX_PARAMS];
  float consts[CONST_MAX];
  int prog[PROG_MAX];
};

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ size_t offset(int t, int K, int k, int jp, int ip,
                                         int j, int i) {
  return ((static_cast<size_t>(t) * K + k) * jp + j) * static_cast<size_t>(ip) + i;
}

// The element of (member m, tile t, k, j, i) in a slot.  Launches over one
// member take kMembers = false and skip the member offset.
template <bool kMembers>
__device__ __forceinline__ float* at(const Shared& s, int slot, int m, int t,
                                     int k, int jp, int ip, int j, int i) {
  float* p = s.ptr[slot] + offset(t, s.kext[slot], k, jp, ip, j, i);
  return kMembers ? p + m * s.mstride[slot] : p;
}

// K reads are edge-clamped into the field's extent, as the reference's
// _k_align (K1) and dynamic_index_in_dim (K2) do.
template <bool kMembers>
__device__ __forceinline__ float load(const Shared& s, int slot, int m, int t,
                                      int k, int jp, int ip, int j, int i) {
  return *at<kMembers>(s, slot, m, t, clampi(k, 0, s.kext[slot] - 1), jp, ip,
                       j, i);
}

// K3: the level search of one point (replaces _march_search).
template <bool kMembers>
__device__ int march_search(const Shared& s, int coord, int m, int t, int jp,
                            int ip, int j, int i, int lo, int hi,
                            float target) {
  int found = lo;
  for (int l = lo + 1; l < hi; ++l) {
    if (load<kMembers>(s, coord, m, t, l, jp, ip, j, i) <= target) found = l;
  }
  return found;
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? (a + b) : fminf(a, b);
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? (a + b) : fmaxf(a, b);
}

__device__ __forceinline__ float sign_of(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : x);
}

// Interpret ops [pc, end) at point (m, t, k, j, i); returns the value.
template <bool kMembers>
__device__ float eval_program(const Shared& s, int pc, int end, int m, int t,
                              int k, int j, int i, int jp, int ip) {
  float stk[STACK_MAX];
  float found[FOUND_MAX];
  int sp = 0;
  while (pc < end) {
    const int op = s.prog[pc++];
    switch (op) {
      case OP_LOAD: {
        const int slot = s.prog[pc], di = s.prog[pc + 1];
        const int dj = s.prog[pc + 2], dk = s.prog[pc + 3];
        pc += 4;
        stk[sp++] = load<kMembers>(s, slot, m, t, k + dk, jp, ip, j + dj,
                                   i + di);
        break;
      }
      case OP_CONST: stk[sp++] = s.consts[s.prog[pc++]]; break;
      case OP_PARAM: stk[sp++] = s.params[s.prog[pc++]]; break;
      case OP_FOUND: stk[sp++] = found[s.prog[pc++]]; break;
      case OP_SEARCH: {
        const int coord = s.prog[pc], lo = s.prog[pc + 1];
        const int hi = s.prog[pc + 2], nf = s.prog[pc + 3];
        pc += 4;
        const float target = stk[--sp];
        const int lvl = march_search<kMembers>(s, coord, m, t, jp, ip, j, i,
                                               lo, hi, target);
        for (int f = 0; f < nf; ++f) {
          const int slot = s.prog[pc], di = s.prog[pc + 1];
          const int dj = s.prog[pc + 2], dk = s.prog[pc + 3];
          pc += 4;
          found[f] = load<kMembers>(s, slot, m, t, lvl + dk, jp, ip, j + dj,
                                    i + di);
        }
        break;
      }
      case OP_NEG: stk[sp - 1] = -stk[sp - 1]; break;
      case OP_SQRT: stk[sp - 1] = sqrtf(stk[sp - 1]); break;
      case OP_ABS: stk[sp - 1] = fabsf(stk[sp - 1]); break;
      case OP_EXP: stk[sp - 1] = expf(stk[sp - 1]); break;
      case OP_LOG: stk[sp - 1] = logf(stk[sp - 1]); break;
      case OP_SIGN: stk[sp - 1] = sign_of(stk[sp - 1]); break;
      case OP_FLOOR: stk[sp - 1] = floorf(stk[sp - 1]); break;
      case OP_WHERE: {
        const float b = stk[--sp];
        const float a = stk[--sp];
        stk[sp - 1] = stk[sp - 1] != 0.f ? a : b;
        break;
      }
      default: {  // binary
        const float b = stk[--sp];
        const float a = stk[sp - 1];
        float r;
        switch (op) {
          case OP_ADD: r = a + b; break;
          case OP_SUB: r = a - b; break;
          case OP_MUL: r = a * b; break;
          case OP_DIV: r = a / b; break;
          case OP_LT: r = a < b ? 1.f : 0.f; break;
          case OP_LE: r = a <= b ? 1.f : 0.f; break;
          case OP_GT: r = a > b ? 1.f : 0.f; break;
          case OP_GE: r = a >= b ? 1.f : 0.f; break;
          case OP_EQ: r = a == b ? 1.f : 0.f; break;
          case OP_NE: r = a != b ? 1.f : 0.f; break;
          case OP_MIN: r = nan_min(a, b); break;
          case OP_MAX: r = nan_max(a, b); break;
          case OP_POW: r = powf(a, b); break;
          default: r = __int_as_float(0x7fc00000); break;  // unknown op: NaN
        }
        stk[sp - 1] = r;
      }
    }
  }
  return stk[0];
}

__device__ void stage(Shared& s, const LaunchArgs& a) {
  for (int x = threadIdx.x; x < a.n_prog; x += blockDim.x) s.prog[x] = a.prog[x];
  for (int x = threadIdx.x; x < a.n_consts; x += blockDim.x) s.consts[x] = a.consts[x];
  for (int x = threadIdx.x; x < a.n_slots; x += blockDim.x) {
    s.ptr[x] = a.ptr[x];
    s.mstride[x] = a.mstride[x];
    s.kext[x] = a.kext[x];
  }
  for (int x = threadIdx.x; x < a.n_params; x += blockDim.x) s.params[x] = a.params[x];
  __syncthreads();
}

// K1: one statement of a PARALLEL computation (replaces _horizontal_kernel).
template <bool kMembers>
__global__ void __launch_bounds__(BLOCK) stencil_parallel_kernel(LaunchArgs a) {
  __shared__ Shared s;
  stage(s, a);
  const long long ni = a.i1 - a.i0, nj = a.j1 - a.j0, nk = a.khi - a.klo;
  const long long nchunk = kMembers ? a.nmember / a.mchunk : 1;
  long long g = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (g >= nchunk * a.ntile * nk * nj * ni) return;
  const int i = a.i0 + static_cast<int>(g % ni); g /= ni;
  const int j = a.j0 + static_cast<int>(g % nj); g /= nj;
  const int k = a.klo + static_cast<int>(g % nk); g /= nk;
  const int t = kMembers ? static_cast<int>(g % a.ntile) : static_cast<int>(g);
  const int chunk = kMembers ? static_cast<int>(g / a.ntile) : 0;
  const int* r = s.prog + 1;  // the single statement record
  const int tgt = r[0];
  const int mchunk = kMembers ? a.mchunk : 1;
  for (int mm = 0; mm < mchunk; ++mm) {
    const int m = chunk * mchunk + mm;
    const float v =
        eval_program<kMembers>(s, r[7], r[8], m, t, k, j, i, a.jp, a.ip);
    *at<kMembers>(s, tgt, m, t, k, a.jp, a.ip, j, i) = v;
  }
}

// K2: a FORWARD/BACKWARD computation, one column per thread (replaces
// _vertical_kernel with the memory-backed carry).
template <bool kMembers>
__global__ void __launch_bounds__(BLOCK) stencil_column_kernel(LaunchArgs a) {
  __shared__ Shared s;
  stage(s, a);
  const long long ni = a.i1 - a.i0, nj = a.j1 - a.j0;
  const long long nchunk = kMembers ? a.nmember / a.mchunk : 1;
  long long g = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (g >= nchunk * a.ntile * nj * ni) return;
  const int i = a.i0 + static_cast<int>(g % ni); g /= ni;
  const int j = a.j0 + static_cast<int>(g % nj); g /= nj;
  const int t = kMembers ? static_cast<int>(g % a.ntile) : static_cast<int>(g);
  const int chunk = kMembers ? static_cast<int>(g / a.ntile) : 0;
  const int n_stmts = s.prog[0];
  const int mchunk = kMembers ? a.mchunk : 1;
  for (int mm = 0; mm < mchunk; ++mm) {
    const int m = chunk * mchunk + mm;
    for (int step = 0; step < a.hi - a.lo; ++step) {
      const int k = a.forward ? a.lo + step : a.hi - 1 - step;
      for (int q = 0; q < n_stmts; ++q) {
        const int* r = s.prog + 1 + REC_INTS * q;
        if (k < r[1] || k >= r[2]) continue;                 // interval
        if (j < r[3] || j >= r[4] || i < r[5] || i >= r[6]) continue;  // region
        const float v =
            eval_program<kMembers>(s, r[7], r[8], m, t, k, j, i, a.jp, a.ip);
        *at<kMembers>(s, r[0], m, t, k, a.jp, a.ip, j, i) = v;
      }
    }
  }
}

static unsigned int blocks_for(long long n) {
  return static_cast<unsigned int>((n + BLOCK - 1) / BLOCK);
}

extern "C" {

// Layout check for the ctypes mirror of LaunchArgs.
int stencil_launch_args_size() { return static_cast<int>(sizeof(LaunchArgs)); }

int stencil_limits(int* out) {
  out[0] = MAX_SLOTS; out[1] = MAX_PARAMS; out[2] = PROG_MAX;
  out[3] = CONST_MAX; out[4] = STACK_MAX; out[5] = FOUND_MAX;
  out[6] = REC_INTS;
  return 0;
}

static long long n_chunks(const LaunchArgs* a) {
  return a->nmember / a->mchunk;
}

// A launch over more than one member takes the kernels' member axis (K5).
int launch_stencil_parallel(const LaunchArgs* a, void* stream) {
  const long long n = n_chunks(a) * a->ntile * (a->khi - a->klo) *
                      (a->j1 - a->j0) * (a->i1 - a->i0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a->nmember > 1)
    stencil_parallel_kernel<true><<<blocks_for(n), BLOCK, 0, st>>>(*a);
  else
    stencil_parallel_kernel<false><<<blocks_for(n), BLOCK, 0, st>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

int launch_stencil_column(const LaunchArgs* a, void* stream) {
  const long long n = n_chunks(a) * a->ntile * (a->j1 - a->j0) *
                      (a->i1 - a->i0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a->nmember > 1)
    stencil_column_kernel<true><<<blocks_for(n), BLOCK, 0, st>>>(*a);
  else
    stencil_column_kernel<false><<<blocks_for(n), BLOCK, 0, st>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

const char* stencil_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
