// Hand-written Hopper kernels for the stencil IR, at every opt level.
//
// One source serves every stencil of the FV3-lite step, fused or not: the
// kernels do not contain any stencil, they interpret it.  The Python encoder
// (repro_torch/core/backend/cuda.py) turns each IR statement into a small
// postfix program of int32 ops plus a float32 constant table; a launch gets
// that program, the field table (pointer and K extent per slot), the scalar
// parameters and the geometry of its iteration space.
//
// Four kernels replace the four Pallas kernels of the reference's path
// (src/repro/core/backend/lowering_pallas.py), and their member axis
// replaces the reference's member grid axis:
//
//   stencil_parallel_kernel  <- _horizontal_kernel (:350)   K1
//   stencil_column_kernel    <- _vertical_kernel   (:486)   K2
//   march_search (device fn) <- _march_search      (:99)    K3
//   stencil_kblocked_kernel  <- _vertical_kernel_kblocked   K4
//                               (:635), _compile_kblocked (:774)
//   nmember/mchunk/mstride   <- _member_index_map,          K5
//                               _member_specs (:207-229)
//
// A fused node (opt 2 and up) is one stencil with many computations; the
// wrapper launches K1 once per PARALLEL statement and K2 once per solver
// computation, in order, so launch order keeps it right.
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
// * K4 runs a single-direction solver under a K-blocked schedule
//   (block_k < nk, block_k | nk): all statements of all computations
//   interleaved per level, in marching order, as the reference's K-blocked
//   kernel runs them.  On the TPU the K slabs are a sequential grid
//   dimension and the carry crosses grid steps in VMEM scratch; a CUDA grid
//   cannot order its blocks, so here the slab walk is a loop inside the
//   kernel.  One CTA owns a tile of consecutive columns (thread = column,
//   neighbouring threads on neighbouring i).  Per slab, the CTA stages the
//   block_k levels of every slot the march reads at the column's own point
//   or writes into shared memory (one coalesced load per level and slot;
//   temporaries, and written fields whose every read in the march follows
//   their write, start at zero and are not read from device memory), syncs,
//   and each thread marches its column's levels out of shared memory,
//   writing program fields through to device memory.  The marching-previous level
//   comes from the slab, or, at a slab's first level, from the carry: the
//   previous slab's last level of every carried slot, kept per thread
//   across slabs and zeroed at each member's first slab (the reference's
//   per-member carry reset).  Reads at a horizontal offset go to device
//   memory; the encoder refuses them for any slot the stencil writes, so
//   columns stay independent.  Bound: device-memory bytes (each field whose
//   old value is read read once, each output written once) like K2; the
//   slab adds no traffic, so the design aims at K2's time, not below it.  With the same
//   eval_program it computes every level as K2 does, bit for bit.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC (plain C interface, ctypes).
// --fmad=false keeps every a*b+c rounded twice, as the plain PyTorch
// version computes it, so results stay within a few ulp of it.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_SLOTS 64
#define MAX_PARAMS 16
#define PROG_MAX 1024
#define CONST_MAX 256
#define STACK_MAX 16
#define FOUND_MAX 8
#define REC_INTS 9
#define BLOCK 256
#define KB_BLOCK 128                      // K4: columns per CTA at most
#define KB_SMEM_BUDGET (200 * 1024)       // K4: dynamic shared memory cap

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
  int sidx[MAX_SLOTS];     // K4: the slot's plane in the slab, -1: not staged
  int cidx[MAX_SLOTS];     // K4: the slot's carry, -1: not carried
  int sload[MAX_SLOTS];    // K4: 1: the slab loads the slot from memory,
                           //     0: it starts at zero
  float params[MAX_PARAMS];
  const int* prog;
  const float* consts;
  int n_prog, n_consts, n_slots, n_params;
  int ntile, jp, ip;
  int klo, khi;            // K1: the statement's interval
  int j0, j1, i0, i1;      // K1: statement box; K2: write window
  int lo, hi, forward;     // K2: the march
  int nmember, mchunk;     // K5: members, and members per thread
  int bk, n_staged, n_carried, nfield;  // K4: slab depth, slab planes,
                                        // carries, slots < nfield are fields
};

struct Shared {
  float* ptr[MAX_SLOTS];
  long long mstride[MAX_SLOTS];
  int kext[MAX_SLOTS];
  int sidx[MAX_SLOTS];
  int cidx[MAX_SLOTS];
  int sload[MAX_SLOTS];
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

// Where a program's LOADs read: device memory at the point (m, t, k, j, i)
// (K1, K2), edge-clamped in K.
template <bool kMembers>
struct GlobalReader {
  const Shared& s;
  int m, t, k, j, i, jp, ip;
  __device__ __forceinline__ float load(int slot, int di, int dj,
                                        int dk) const {
    return load_at(slot, k + dk, di, dj);
  }
  __device__ __forceinline__ float load_at(int slot, int lvl, int di,
                                           int dj) const {
    return ::load<kMembers>(s, slot, m, t, lvl, jp, ip, j + dj, i + di);
  }
  __device__ __forceinline__ int search(int coord, int lo, int hi,
                                        float target) const {
    return march_search<kMembers>(s, coord, m, t, jp, ip, j, i, lo, hi,
                                  target);
  }
};

// K4's reads: the column's own point from the slab (the current level, or
// the marching-previous one: the slab's level before, or at the slab's
// first level the carry), horizontal offsets from device memory.
template <bool kMembers>
struct SlabReader {
  GlobalReader<kMembers> g;
  const float* slab;
  const float* carry;
  int local, bk, nthr, tid;
  __device__ __forceinline__ float load(int slot, int di, int dj,
                                        int dk) const {
    if (di != 0 || dj != 0) return g.load(slot, di, dj, dk);
    const int lp = local + dk;
    if (lp >= 0 && lp < bk)
      return slab[(g.s.sidx[slot] * bk + lp) * nthr + tid];
    return carry[g.s.cidx[slot]];
  }
  __device__ __forceinline__ float load_at(int slot, int lvl, int di,
                                           int dj) const {
    return g.load_at(slot, lvl, di, dj);
  }
  __device__ __forceinline__ int search(int coord, int lo, int hi,
                                        float target) const {
    return g.search(coord, lo, hi, target);
  }
};

// Interpret ops [pc, end), reading fields through ``rd``; returns the value.
template <class Reader>
__device__ float eval_program(const Shared& s, int pc, int end,
                              const Reader rd) {
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
        stk[sp++] = rd.load(slot, di, dj, dk);
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
        const int lvl = rd.search(coord, lo, hi, target);
        for (int f = 0; f < nf; ++f) {
          const int slot = s.prog[pc], di = s.prog[pc + 1];
          const int dj = s.prog[pc + 2], dk = s.prog[pc + 3];
          pc += 4;
          found[f] = rd.load_at(slot, lvl + dk, di, dj);
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
    s.sidx[x] = a.sidx[x];
    s.cidx[x] = a.cidx[x];
    s.sload[x] = a.sload[x];
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
    const GlobalReader<kMembers> rd{s, m, t, k, j, i, a.jp, a.ip};
    const float v = eval_program(s, r[7], r[8], rd);
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
        const GlobalReader<kMembers> rd{s, m, t, k, j, i, a.jp, a.ip};
        const float v = eval_program(s, r[7], r[8], rd);
        *at<kMembers>(s, r[0], m, t, k, a.jp, a.ip, j, i) = v;
      }
    }
  }
}

// K4: a single-direction solver under a K-blocked schedule (replaces
// _vertical_kernel_kblocked): one thread per column, a loop over the
// nk / bk slabs in marching order, each slab staged in shared memory.
template <bool kMembers>
__global__ void __launch_bounds__(KB_BLOCK) stencil_kblocked_kernel(
    LaunchArgs a) {
  __shared__ Shared s;
  extern __shared__ float slab[];  // [n_staged][bk][blockDim.x]
  stage(s, a);
  const int nthr = blockDim.x, tid = threadIdx.x;
  const long long ni = a.i1 - a.i0, nj = a.j1 - a.j0;
  const long long nchunk = kMembers ? a.nmember / a.mchunk : 1;
  long long g = static_cast<long long>(blockIdx.x) * nthr + tid;
  // threads past the last column still stage and sync with the others
  const bool valid = g < nchunk * a.ntile * nj * ni;
  int i = a.i0, j = a.j0, t = 0, chunk = 0;
  if (valid) {
    i = a.i0 + static_cast<int>(g % ni); g /= ni;
    j = a.j0 + static_cast<int>(g % nj); g /= nj;
    t = kMembers ? static_cast<int>(g % a.ntile) : static_cast<int>(g);
    chunk = kMembers ? static_cast<int>(g / a.ntile) : 0;
  }
  const int n_stmts = s.prog[0];
  const int mchunk = kMembers ? a.mchunk : 1;
  const int bk = a.bk;
  const int nblocks = (a.hi - a.lo) / bk;
  float carry[MAX_SLOTS];
  for (int mm = 0; mm < mchunk; ++mm) {
    const int m = chunk * mchunk + mm;
    for (int c = 0; c < a.n_carried; ++c) carry[c] = 0.f;  // per member
    for (int b = 0; b < nblocks; ++b) {
      const int k0 = a.lo + (a.forward ? b : nblocks - 1 - b) * bk;
      __syncthreads();  // every thread is done with the previous slab
      for (int slot = 0; slot < a.n_slots; ++slot) {
        const int si = s.sidx[slot];
        if (si < 0) continue;
        const bool from_memory = valid && s.sload[slot];
        for (int lvl = 0; lvl < bk; ++lvl)
          slab[(si * bk + lvl) * nthr + tid] =
              from_memory ? *at<kMembers>(s, slot, m, t, k0 + lvl, a.jp,
                                          a.ip, j, i)
                          : 0.f;
      }
      __syncthreads();
      if (!valid) continue;
      for (int step = 0; step < bk; ++step) {
        const int local = a.forward ? step : bk - 1 - step;
        const int k = k0 + local;
        const SlabReader<kMembers> rd{{s, m, t, k, j, i, a.jp, a.ip},
                                      slab, carry, local, bk, nthr, tid};
        for (int q = 0; q < n_stmts; ++q) {
          const int* r = s.prog + 1 + REC_INTS * q;
          if (k < r[1] || k >= r[2]) continue;                 // interval
          if (j < r[3] || j >= r[4] || i < r[5] || i >= r[6]) continue;  // region
          const float v = eval_program(s, r[7], r[8], rd);
          slab[(s.sidx[r[0]] * bk + local) * nthr + tid] = v;
          if (r[0] < a.nfield)
            *at<kMembers>(s, r[0], m, t, k, a.jp, a.ip, j, i) = v;
        }
      }
      // the carry: the last marched level of every carried slot
      const int last = a.forward ? bk - 1 : 0;
      for (int slot = 0; slot < a.n_slots; ++slot)
        if (s.cidx[slot] >= 0)
          carry[s.cidx[slot]] = slab[(s.sidx[slot] * bk + last) * nthr + tid];
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

// K4: as many columns per CTA (up to KB_BLOCK, down to a warp) as the
// slab's shared memory allows.
int launch_stencil_kblocked(const LaunchArgs* a, void* stream) {
  const size_t per_col = static_cast<size_t>(a->n_staged) * a->bk *
                         sizeof(float);
  int threads = KB_BLOCK;
  while (threads > 32 && per_col * threads > KB_SMEM_BUDGET) threads /= 2;
  const size_t bytes = per_col * threads;
  if (bytes > KB_SMEM_BUDGET) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = n_chunks(a) * a->ntile * (a->j1 - a->j0) *
                      (a->i1 - a->i0);
  const unsigned int blocks =
      static_cast<unsigned int>((n + threads - 1) / threads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t rc;
  if (a->nmember > 1) {
    rc = cudaFuncSetAttribute(stencil_kblocked_kernel<true>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
    if (rc != cudaSuccess) return static_cast<int>(rc);
    stencil_kblocked_kernel<true><<<blocks, threads, bytes, st>>>(*a);
  } else {
    rc = cudaFuncSetAttribute(stencil_kblocked_kernel<false>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
    if (rc != cudaSuccess) return static_cast<int>(rc);
    stencil_kblocked_kernel<false><<<blocks, threads, bytes, st>>>(*a);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* stencil_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
