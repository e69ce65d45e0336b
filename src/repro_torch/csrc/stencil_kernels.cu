// Hand-written Hopper kernels for the stencil IR, at every opt level.
//
// One source serves every stencil of the FV3-lite step, fused or not: the
// kernels do not contain any stencil, they interpret it.  The Python encoder
// (repro_torch/core/backend/cuda.py) turns each IR statement into a record
// (target, levels, box) and a postfix stream of int32 op words plus a
// float32 constant table; a launch gets the records and the stream, the
// field table (pointer, member stride and K extent per slot), the scalar
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
// wrapper launches K1 once per group of consecutive PARALLEL statements
// (cuda.parallel_groups) and K2 once per solver computation, in order.
//
// The interpreter.  An op word is src << 22 | op << 16 | depth, where
// depth, the number of values on the stack before the op, is fixed when the
// stream is encoded.  The top of the stack lives in registers, ``acc[P]``
// for the P points a thread evaluates at once; the entries below it live
// in shared memory, [depth][P][thread] (each warp access conflict-free),
// addressed by the depth.  So one switch over ~35 opcodes decodes an op:
// a switch over (op, depth) pairs, which would keep the whole stack in
// registers, compiles to a ~10-level tree of compares and branches (nvcc
// builds no jump table that large) and cost more than the stack traffic.
// A push or a binary op names its operand's source in the word (a load, a
// constant, a parameter, a stack entry), so ``x op leaf`` is one dispatch
// with no stack traffic; the encoder orders each operation's operands to
// keep the stack shallow (the deeper first; the reversed op when the
// right one went first) and every op computes what the plain version
// computes, so results stay bit for bit.
//
// What bounds them on an H100, and what the design does about it:
//
// * K1 runs a group of statements: one thread per (tile, K span, j, i)
//   walks its column's levels in strips of P = 8 and runs every record of
//   the group on each strip, in order, each masked by its levels and box.
//   A statement joins the group unless it reads an earlier member's target
//   away from the point or writes what an earlier member read away from
//   the point, so no thread sees another mid-launch; a temporary that only
//   later members read, inside its box, stays on the stack (``KEEP``) and
//   is never stored.  A stencil statement reads a handful of f32 words per
//   point and writes one, so the floor is device-memory bandwidth (3.35
//   TB/s); the interpreter is bound by issuing its instructions (a decode
//   and ~P arithmetic instructions per op) and by shared-memory traffic,
//   which the strip amortises over P points and the sources cut.
//   Neighbouring threads take neighbouring i, so loads and stores coalesce;
//   the records, stream, constants and field table are staged in shared
//   memory once per CTA (each table sized by what the launch holds:
//   Tables), each CTA's threads walk K spans of several strips,
//   and the launch is cut into enough spans (cuda.k1_span) to fill the SMs.
//   Pallas holds the whole IJ plane in one block and runs a stencil's
//   statements in order inside it; blocks of a CUDA grid run in no order,
//   so a launch boundary orders what the group rule cuts apart.
// * K2 runs a FORWARD/BACKWARD computation: one thread per K2_COLS = 4
//   neighbouring columns (rows j .. j + 3 at one i, so each column's warp
//   access stays one coalesced line) marches k over [lo, hi) forward or
//   backward and runs the computation's records at each level for its 4
//   columns at once, each masked by its levels and, per column, by its
//   box.  Its bound is device-memory bytes like K1's, but the march is a
//   chain of levels, and the interpreter's work per level is a chain of
//   dependent instructions; with 4 columns a thread a C192 tile set has
//   ~13 warps an SM, so K2 waits on latency, and the design takes the
//   waits off the chain:
//   - the carry on chip: a slot the march writes and reads at the
//     marching-previous level is read (``CARRY``) from the value the
//     thread stored there, kept in shared memory [carried][level parity]
//     [column][thread], where the opt-0 design reloaded it from device
//     memory just after storing it; a column that stored nothing at the
//     level before (the march's first level, a record's box) reads memory;
//   - the next level's loads copied ahead: every read that no store of the
//     march can change before it (``AHEAD``: slots it never writes, and
//     written ones at their own level before any store of them) is copied
//     by cp.async into shared memory while the level before runs, one
//     commit group a level, so a level's loads wait on nothing;
//   - one decode for 4 chains: each op is decoded once for the 4 columns,
//     and a binary op of two leaves takes both from sources (``src2``),
//     one op where a push and the op were two;
//   - addresses once: a column's base address of each slot is computed
//     once a thread (a table in shared memory), and the 4 columns sit
//     joff[p] floats apart.
//   Columns are independent (the encoder refuses horizontal-offset reads
//   of fields the computation writes), so no synchronisation is needed;
//   every value is the one the plain version computes, bit for bit.
// * K3 is the `index_search` level search, for the P points of a strip at
//   once: they share the column, so it is read once for all of them, from
//   the top layer down, 8 layers a load batch, until every point has the
//   last layer whose coordinate does not exceed its target; a batch whose
//   least coordinate exceeds every open target is passed over.  This is
//   the reference's marching rule on any column (no order assumed, a NaN
//   never taken), not a bisection.  The at_found values are read once, at
//   the end, onto the stack.
// * K5, the ensemble member axis.  Pallas puts members on the outermost
//   sequential grid axis, one member (or one C-member chunk) per step.
//   Here a launch covers nmember members: K1 runs one thread per (member
//   chunk, tile, K span, j, i) and K2 one per (member chunk, tile, 4 rows
//   j, i), and each thread loops over the mchunk members of its chunk
//   (mchunk = 1 under "grid", C under "vmap:C,grid"); K2 runs the march
//   again from lo for each member, its carry emptied.  A
//   slot's member offset is m * mstride[slot] in 64 bits; mstride is 0 for
//   a field broadcast across members (the metric terms), so an expanded
//   tensor reaches the kernel without M copies.  The launch count of a
//   step does not change with M.  The work per member is K1/K2's, so the
//   bound and the cost scale with M; a chunk's members each decode the
//   program again.  Both kernels are templated on kMembers: a launch over
//   one member (the sequential step) takes the instance without the member
//   offset and the chunk loop, so the member axis costs that path nothing.
// * K4 runs a single-direction solver under a K-blocked schedule
//   (block_k < nk, block_k | nk): all statements of all computations
//   interleaved per level, in marching order, as the reference's K-blocked
//   kernel runs them.  On the TPU the K slabs are a sequential grid
//   dimension, each staged whole in VMEM, and the carry crosses grid steps
//   in VMEM scratch.  Here a slab is only a depth of prefetch: K4 is K2's
//   march (the same template, kBlocked) over the interleaved statements and
//   all nk levels, 4 columns a thread, the carry on chip, and the copies
//   ahead taken a group of G levels at a time: at the first level of a
//   group one commit group copies the next group's AHEAD keys, double-
//   buffered.  G is the slab, at most 4 levels (cuda.KB_DEPTH_MAX: the
//   interpreter's chain, not device memory, bounds the march, and deeper
//   groups, issued at once, measured slower), fewer where two groups would
//   pass the 48 KB that keeps four CTAs an SM.  No barrier: each thread
//   copies and waits for its own columns.  A group's levels share each
//   record's activity: K4 decides once a group, for its thread, which
//   records no level of it runs and which run at every level (with their
//   columns), where K2 tests each record's levels and box at each level.  The reference zeroes its carry
//   at each member's first slab: the level before K4's first lies outside
//   every slot's K extent, and K4 reads 0 there, its carry entries zeroed
//   and marked held and the first level's copies of keys a level up zeroed
//   (the encoder routes every such read through the two), where K2 clamps
//   it.  Bound: device-memory bytes, like K2's; every value is the one K2
//   and the plain version compute, bit for bit, wherever such a read is
//   dead.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC (plain C interface, ctypes).
// --fmad=false keeps every a*b+c rounded twice, as the plain PyTorch
// version computes it, so results stay within a few ulp of it.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#define REC_INTS 9
#define OPW 65536                         // op word: op * OPW + depth
#define K2_BLOCK 128                      // K2: threads per CTA
#define K2_COLS 4                         // K2: columns a thread
#define CARRY_MAX 8                       // K2: slots carried on chip
#define AHEAD_MAX 8                       // K2: loads copied a level ahead
#define K1_BLOCK 128                      // K1: threads per CTA
#define K1_STRIP 8                        // K1: levels each op evaluates
#define SMEM_MAX (227 * 1024)             // a CTA's shared memory on sm_90
// The slot table and parameters travel as a kernel parameter: an instance
// with room for TABLE_SMALL 8-byte words (a stencil of up to 80 fields and
// temporaries, as every FV3 program), and one with TABLE_LARGE, what
// Hopper's 32 KB of kernel parameters hold beside the header
#define TABLE_SMALL 256
#define TABLE_LARGE 4000

// opcodes — keep in sync with cuda.py.  An op word is
//   src2 << SRC2_SHIFT | src << SRC_SHIFT | op * OPW | depth:
// the stack depth before the op (the top of the stack is a register,
// ``acc``, the entries below it sit in shared memory at their depth),
// where a push or a binary op takes its operand from, and (K2, K4) where
// a binary op takes its first operand from: it then pushes f(src2, src).
// The operand words follow: src2's, src's, then the op's.
#define OP_SHIFT 16
#define SRC_SHIFT 22
#define SRC2_SHIFT 25  // K2, K4: a binary op's first operand's source
enum {            // sources: their operand words follow the op word
  SRC_LOAD = 1,   // slot di dj dk
  SRC_CONST = 2,  // index into the constant table
  SRC_PARAM = 3,  // index into the parameter array
  SRC_PICK = 4,   // j: a copy of stack entry j
  SRC_CARRY = 5,  // slot di dj dk (K2, K4): the marching-previous level of
                  // a slot the march writes, from the carry where it is held
  SRC_AHEAD = 6   // j (K2, K4): key j of the ahead table, copied into
                  // shared memory while the level (K4: slab) before ran
};
enum {
  OP_PUSH = 0,    // pushes its source
  OP_FLOAD = 1,   // slot di dj dk: pushes a read at the found level
  OP_SEARCH = 2,  // coord lo hi ; pops the target, selects the level
  OP_STORE = 3,   // slot ; pops the value into the slot at the point
  OP_KEEP = 4,    // the value stays on the stack for a later record
  OP_DROP = 5,    // n: the top replaces the n entries below it
  OP_NEG = 8, OP_SQRT, OP_ABS, OP_EXP, OP_LOG, OP_SIGN, OP_FLOOR,
  // f(a, b): without a source a is the entry below the top and b the top
  // (both popped); with one, a is the top and b the source
  OP_ADD = 16, OP_SUB, OP_MUL, OP_DIV, OP_LT, OP_LE, OP_GT, OP_GE, OP_EQ,
  OP_NE, OP_MIN, OP_MAX, OP_POW,
  // f(b, a): the IR's right operand was evaluated first
  OP_RSUB, OP_RDIV, OP_RMIN, OP_RMAX, OP_RPOW,
  OP_WHERE = 34   // pops b, a, cond
};

// One launch.  The program buffer starts with the statement records:
//   prog[0] = n_stmts; then per statement REC_INTS ints:
//   target klo khi j0 j1 i0 i1 op_begin op_end
// (j/i bounds in padded coordinates, the write window cut to the region).
struct LaunchHeader {
  const int* prog;         // the records and ops (device memory)
  const float* consts;     // the constant table (device memory)
  int n_prog, n_consts, n_slots, n_params;
  int ntile, jp, ip;
  int klo, khi;            // K1: the levels of all records
  int kspan;               // K1: levels per thread, a multiple of K1_STRIP
  int depth;               // stack entries the ops reach
  int j0, j1, i0, i1;      // K1: box of all records; K2: write window
  int lo, hi, forward;     // K2, K4: the march
  int nmember, mchunk;     // K5: members, and members per thread
  int bk, n_carried;       // K4: levels a copy group holds; K2, K4: carries
  int ahead_begin, ahead_end;  // K2, K4: prog[ahead_begin, ahead_end), the
                               // ahead table (slot di dj dk each)
};

// The kernels' parameter: the header, then the slot table and the
// parameters as Tables lays them out from Tables::ptr on (pointers, member
// strides: elements between members, 0 for a broadcast field; K extents;
// K2's and K4's carry index of each slot, -1 where it is not carried; the
// parameters), in 8-byte words.
template <int kWords>
struct LaunchArgs {
  LaunchHeader h;
  unsigned long long table[kWords];
};

// the stack; K2, K4: carry, copies; all after the tables
extern __shared__ __align__(16) float dynamic_smem[];

// A launch's tables in dynamic shared memory, each sized by what its
// program holds, at these offsets (4-byte words): the records and ops at
// 0 (the interpreter's most frequent reads need no offset), then the slot
// table, the parameters and the constants.  ``words`` is where the stack
// and the rest begin, 16-byte aligned.  The host computes the same layout
// (cuda.py's table_words) to size the launch.
struct Tables {
  int ptr, mstride, kext, cidx, params, consts, words;
  __host__ __device__ explicit Tables(const LaunchHeader& h) {
    ptr = (h.n_prog + 1) & ~1;  // 8-byte entries on an even word
    mstride = ptr + 2 * h.n_slots;
    kext = mstride + 2 * h.n_slots;
    cidx = kext + h.n_slots;
    params = cidx + h.n_slots;
    consts = (params + h.n_params + 1) & ~1;  // the kernel parameter's end
    words = (consts + h.n_consts + 3) & ~3;
  }
  // 8-byte words of the kernel parameter's table
  __host__ __device__ int param_words() const { return (consts - ptr) / 2; }
  __device__ __forceinline__ float* field(int slot) const {
    return reinterpret_cast<float* const*>(dynamic_smem + ptr)[slot];
  }
  __device__ __forceinline__ long long member_stride(int slot) const {
    return reinterpret_cast<const long long*>(dynamic_smem + mstride)[slot];
  }
  __device__ __forceinline__ int k_extent(int slot) const {
    return reinterpret_cast<const int*>(dynamic_smem + kext)[slot];
  }
  __device__ __forceinline__ int carry_index(int slot) const {
    return reinterpret_cast<const int*>(dynamic_smem + cidx)[slot];
  }
  __device__ __forceinline__ float param(int x) const {
    return dynamic_smem[params + x];
  }
  __device__ __forceinline__ float constant(int x) const {
    return dynamic_smem[consts + x];
  }
};

// word x of the records and ops
__device__ __forceinline__ int prog_at(int x) {
  return reinterpret_cast<const int*>(dynamic_smem)[x];
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// The column (member m, tile t, j, i) of a slot: its level k is
// column[k * jp * ip].
template <bool kMembers>
__device__ __forceinline__ float* column(const Tables& s, int slot, int m,
                                         int t, int jp, int ip, int j,
                                         int i) {
  float* p = s.field(slot) +
             (static_cast<size_t>(t) * s.k_extent(slot) * jp + j) *
                 static_cast<size_t>(ip) + i;
  return kMembers ? p + m * s.member_stride(slot) : p;
}

// K3: the level search of P points of one column (replaces _march_search):
// the last layer l in (lo, hi) with col[l] <= target[p], else lo.  The
// march runs from the top layer down, SEARCH_CHUNK layers at a time (their
// loads issued together), and stops once every point has its layer: a
// column is read once for the P targets of a strip, and a point reads only
// the layers above its own.  A chunk whose least coordinate exceeds every
// open target holds no layer for any point and is passed over; the others
// are tested layer by layer, highest first.  A NaN compares false and is
// never taken (fminf and fmaxf pass over it too), and no order of the
// column is assumed.
#define SEARCH_CHUNK 8
template <int P>
__device__ __forceinline__ void march_search(const float* col, int kext,
                                             size_t plane, int lo, int hi,
                                             const float (&target)[P],
                                             int (&lvl)[P]) {
  const float nan = __int_as_float(0x7fc00000);
  unsigned open = (1u << P) - 1u;
  float reach = nan;  // the largest open target
#pragma unroll
  for (int p = 0; p < P; ++p) {
    lvl[p] = lo;
    reach = fmaxf(reach, target[p]);
  }
  for (int top = hi - 1; top > lo && open; top -= SEARCH_CHUNK) {
    float c[SEARCH_CHUNK], least = nan;
#pragma unroll
    for (int u = 0; u < SEARCH_CHUNK; ++u) {
      c[u] = top - u > lo ? col[clampi(top - u, 0, kext - 1) * plane] : nan;
      least = fminf(least, c[u]);
    }
    if (!(least <= reach)) continue;
#pragma unroll
    for (int u = 0; u < SEARCH_CHUNK; ++u) {
#pragma unroll
      for (int p = 0; p < P; ++p) {
        if (((open >> p) & 1u) && c[u] <= target[p]) {
          lvl[p] = top - u;
          open &= ~(1u << p);
        }
      }
    }
    reach = nan;
#pragma unroll
    for (int p = 0; p < P; ++p)
      if ((open >> p) & 1u) reach = fmaxf(reach, target[p]);
  }
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

// The stack below its top: shared memory, [depth][P][thread].
template <int P>
struct Stack {
  float* base;  // this thread's entry 0 of point 0
  int nthr;
  __device__ __forceinline__ float& at(int d, int p) const {
    return base[(d * P + p) * nthr];
  }
};

// K2's: the same layout, addressed by an index into dynamic_smem (a
// shared-memory address from a constant base, where a pointer would be a
// generic one to convert at every access)
template <int P>
struct SharedStack {
  int base;  // this thread's entry 0 of point 0
  int nthr;
  __device__ __forceinline__ float& at(int d, int p) const {
    return dynamic_smem[base + (d * P + p) * nthr];
  }
};

// K1's reads and writes: a strip of P levels k0 .. k0 + P - 1 of the column
// (m, t, j, i); K reads edge-clamped into the field's extent, as the
// reference's _k_align does, and a store masked to the record's levels.
template <bool kMembers, int P>
struct StripReader {
  static constexpr bool kCarry = false;
  const Tables& s;
  int m, t, j, i, k0, jp, ip;
  __device__ __forceinline__ float* col(int slot, int di, int dj) const {
    return column<kMembers>(s, slot, m, t, jp, ip, j + dj, i + di);
  }
  __device__ __forceinline__ void load(int slot, int di, int dj, int dk,
                                       float (&out)[P]) const {
    const float* c = col(slot, di, dj);
    const int kext = s.k_extent(slot), k = k0 + dk, plane = jp * ip;
    if (k >= 0 && k + P <= kext) {
#pragma unroll
      for (int p = 0; p < P; ++p) out[p] = c[(k + p) * plane];
    } else {
#pragma unroll
      for (int p = 0; p < P; ++p)
        out[p] = c[clampi(k + p, 0, kext - 1) * plane];
    }
  }
  __device__ __forceinline__ void load_found(int slot, int di, int dj, int dk,
                                             const int (&lvl)[P],
                                             float (&out)[P]) const {
    const float* c = col(slot, di, dj);
    const int kext = s.k_extent(slot), plane = jp * ip;
#pragma unroll
    for (int p = 0; p < P; ++p)
      out[p] = c[clampi(lvl[p] + dk, 0, kext - 1) * plane];
  }
  __device__ __forceinline__ void search(int coord, int lo, int hi,
                                         const float (&target)[P],
                                         int (&lvl)[P]) const {
    march_search<P>(col(coord, 0, 0), s.k_extent(coord),
                    static_cast<size_t>(jp) * ip, lo, hi, target, lvl);
  }
  __device__ __forceinline__ void store(int slot, const float (&v)[P],
                                        int klo, int khi) const {
    float* c = col(slot, 0, 0);
    const int plane = jp * ip;
#pragma unroll
    for (int p = 0; p < P; ++p)
      if (k0 + p >= klo && k0 + p < khi) c[(k0 + p) * plane] = v[p];
  }
};

// K2's and K4's column table: row j's column (t, j, i) of every slot,
// computed once a thread, in shared memory [slot][thread]; cell() is the
// point (di, dj) away from it at level kk, edge-clamped into the slot's K
// extent, of member m.
template <bool kMembers>
__device__ __forceinline__ float* cell(const Tables& s, float* const* cols,
                                       int nthr, int slot, int m, int jp,
                                       int ip, int di, int dj, int kk) {
  float* c = cols[slot * nthr] + dj * ip + di +
             static_cast<size_t>(clampi(kk, 0, s.k_extent(slot) - 1)) * jp * ip;
  return kMembers ? c + m * s.member_stride(slot) : c;
}

// K2's and K4's reads and writes: level k of P neighbouring columns (m, t,
// j + p, i), rows j .. j + P - 1 at one i; the column of row j + p is
// joff[p] floats from row j's (a row past the window is clamped to its last
// row: it reads in bounds and stores nothing), so an address is computed
// once for the P columns.  A store is masked per column by ``live``; a
// level search runs per column.  The marching carry: a store to a carried
// slot also writes the value of each column it stores to shared memory,
// [carried][level parity][P][thread], and sets the (slot, column) bit of
// ``cur``; a CARRY read, of the marching-previous level, takes the value
// from there where that bit is set in ``prev`` (``cur`` of the level
// before), and from device memory where the column stored none.  An AHEAD
// read takes its key's value from ``ahead``, [key][P][thread] of this
// level, which cp.async filled while the level (K4: the slab) before ran.
template <bool kMembers, int P>
struct ColumnReader {
  static constexpr bool kCarry = true;
  const Tables& s;
  int m, k, jp, ip;
  float* const* cols;  // this thread's entry of the table of row j's columns
  int joff[P];
  unsigned live;
  int cv;     // this thread's carry entry 0, in dynamic_smem
  int ahead;  // this thread's entry 0 of this level's copies
  int nthr;
  unsigned cur;        // the carry's bits of this level's stores
  unsigned prev;       // and of the level before's
  __device__ __forceinline__ float* col(int slot, int di, int dj,
                                        int kk) const {
    return cell<kMembers>(s, cols, nthr, slot, m, jp, ip, di, dj, kk);
  }
  __device__ __forceinline__ float& held(int c, int kk, int p) const {
    return dynamic_smem[cv + ((c * 2 + (kk & 1)) * P + p) * nthr];
  }
  __device__ __forceinline__ void load(int slot, int di, int dj, int dk,
                                       float (&out)[P]) const {
    const float* c = col(slot, di, dj, k + dk);
#pragma unroll
    for (int p = 0; p < P; ++p) out[p] = c[joff[p]];
  }
  __device__ __forceinline__ void load_found(int slot, int di, int dj, int dk,
                                             const int (&lvl)[P],
                                             float (&out)[P]) const {
#pragma unroll
    for (int p = 0; p < P; ++p)
      out[p] = col(slot, di, dj, lvl[p] + dk)[joff[p]];
  }
  __device__ __forceinline__ void search(int coord, int lo, int hi,
                                         const float (&target)[P],
                                         int (&lvl)[P]) const {
    const float* c = col(coord, 0, 0, 0);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const float one[1] = {target[p]};
      int got[1];
      march_search<1>(c + joff[p], s.k_extent(coord),
                      static_cast<size_t>(jp) * ip, lo, hi, one, got);
      lvl[p] = got[0];
    }
  }
  __device__ __forceinline__ void carry(int slot, int dk,
                                        float (&out)[P]) const {
    const int c = s.carry_index(slot), kk = k + dk;
    const unsigned have = (prev >> (c * P)) & ((1u << P) - 1u);
    if (have == (1u << P) - 1u) {
#pragma unroll
      for (int p = 0; p < P; ++p) out[p] = held(c, kk, p);
      return;
    }
    const float* mem = col(slot, 0, 0, kk);
#pragma unroll
    for (int p = 0; p < P; ++p)
      out[p] = (have >> p) & 1u ? held(c, kk, p) : mem[joff[p]];
  }
  __device__ __forceinline__ void copied(int key, float (&out)[P]) const {
#pragma unroll
    for (int p = 0; p < P; ++p)
      out[p] = dynamic_smem[ahead + (key * P + p) * nthr];
  }
  __device__ __forceinline__ void store(int slot, const float (&v)[P], int,
                                        int) {
    float* c = col(slot, 0, 0, k);
#pragma unroll
    for (int p = 0; p < P; ++p)
      if ((live >> p) & 1u) c[joff[p]] = v[p];
    const int ci = s.carry_index(slot);
    if (ci >= 0) {
      // only the columns stored: an earlier store of the slot at this
      // level may hold the others
#pragma unroll
      for (int p = 0; p < P; ++p)
        if ((live >> p) & 1u) held(ci, k, p) = v[p];
      cur |= live << (ci * P);
    }
  }
};

// -- the interpreter -----------------------------------------------------
// One switch over the opcode.  An op works on P points at once: the top of
// the stack is ``acc[P]`` in registers, entry d of point p below it is
// ``Stack::at(d, p)`` in shared memory, laid out [depth][P][thread] so a
// warp's accesses fall on 32 banks.  A push writes the old top to its
// entry; an op that takes the top and the entry below reads that entry
// from shared memory; a pop reloads the new top.  Between records every
// entry below the top is in shared memory (``KEEP`` writes a kept value
// there), so a record skipped by its box or levels leaves the rest right.

#define UNROLL_P _Pragma("unroll") for (int p = 0; p < P; ++p)
#define BINARY(op, expr)                                                  \
  case op:                                                                \
    UNROLL_P {                                                            \
      const float x = a[p], y = b[p];                                     \
      acc[p] = (expr);                                                    \
    }                                                                     \
    break;
#define UNARY(op, f)                                                      \
  case op:                                                                \
    UNROLL_P acc[p] = f(acc[p]);                                          \
    break;
#define NEG_OF(x) (-(x))

// The P values of source src (stack depth d before the op), its operand
// words from pc on; advances pc past them.
template <int P, class Reader, class Stk>
__device__ __forceinline__ void read_source(const Tables& s, int src, int d,
                                            int& pc, Reader& rd,
                                            const Stk& st,
                                            const float (&acc)[P],
                                            float (&out)[P]) {
  const int arg = pc;  // the operand words: prog_at(arg), ...
  if constexpr (Reader::kCarry) {  // K2's own sources
    if (src == SRC_CARRY) {
      rd.carry(prog_at(arg), prog_at(arg + 3), out);
      pc += 4;
      return;
    }
    if (src == SRC_AHEAD) {
      rd.copied(prog_at(arg), out);
      pc += 1;
      return;
    }
  }
  switch (src) {
    case SRC_LOAD:
      rd.load(prog_at(arg), prog_at(arg + 1), prog_at(arg + 2),
              prog_at(arg + 3), out);
      pc += 4;
      break;
    case SRC_CONST: {
      const float c = s.constant(prog_at(arg));
      UNROLL_P out[p] = c;
      pc += 1;
      break;
    }
    case SRC_PARAM: {
      const float c = s.param(prog_at(arg));
      UNROLL_P out[p] = c;
      pc += 1;
      break;
    }
    default:  // SRC_PICK: the top is acc, the entries below in memory
      if (prog_at(arg) == d - 1) {
        UNROLL_P out[p] = acc[p];
      } else {
        UNROLL_P out[p] = st.at(prog_at(arg), p);
      }
      pc += 1;
  }
}

// Interpret the ops [pc, end) of one record for the P points of ``rd``;
// ``lvl`` holds the enclosing search's levels.
template <int P, class Reader, class Stk>
__device__ __forceinline__ void run_ops(const Tables& s, int pc,
                                        const int end, Reader& rd,
                                        const Stk& st, float (&acc)[P],
                                        int (&lvl)[P], const int klo,
                                        const int khi) {
  while (pc < end) {
    const unsigned w = static_cast<unsigned>(prog_at(pc++));
    const int d = w & (OPW - 1), op = (w >> OP_SHIFT) & 63;
    const int src = (w >> SRC_SHIFT) & 7;
    float b[P];   // the source's values
    float a2[P];  // K2: a binary op's first operand, from src2
    bool pair = false;
    if constexpr (Reader::kCarry) {
      const int src2 = w >> SRC2_SHIFT;
      if (src2 != 0) {
        read_source<P>(s, src2, d, pc, rd, st, acc, a2);
        pair = true;
      }
    }
    if (src != 0) read_source<P>(s, src, d, pc, rd, st, acc, b);
    const int arg = pc;  // the op's operand words
    if (op >= OP_ADD && op <= OP_RPOW) {
      float a[P];
      if (pair) {  // f(src2, src) is pushed
        if (d > 0) { UNROLL_P st.at(d - 1, p) = acc[p]; }
        UNROLL_P a[p] = a2[p];
      } else if (src != 0) {
        UNROLL_P a[p] = acc[p];
      } else {
        UNROLL_P {
          a[p] = st.at(d - 2, p);
          b[p] = acc[p];
        }
      }
      switch (op) {
        BINARY(OP_ADD, x + y) BINARY(OP_SUB, x - y) BINARY(OP_MUL, x * y)
        BINARY(OP_DIV, x / y) BINARY(OP_LT, x < y ? 1.f : 0.f)
        BINARY(OP_LE, x <= y ? 1.f : 0.f) BINARY(OP_GT, x > y ? 1.f : 0.f)
        BINARY(OP_GE, x >= y ? 1.f : 0.f) BINARY(OP_EQ, x == y ? 1.f : 0.f)
        BINARY(OP_NE, x != y ? 1.f : 0.f) BINARY(OP_MIN, nan_min(x, y))
        BINARY(OP_MAX, nan_max(x, y)) BINARY(OP_POW, powf(x, y))
        BINARY(OP_RSUB, y - x) BINARY(OP_RDIV, y / x)
        BINARY(OP_RMIN, nan_min(y, x)) BINARY(OP_RMAX, nan_max(y, x))
        default:  // OP_RPOW
          UNROLL_P acc[p] = powf(b[p], a[p]);
      }
      continue;
    }
    switch (op) {
      case OP_PUSH:
        if (d > 0) { UNROLL_P st.at(d - 1, p) = acc[p]; }
        UNROLL_P acc[p] = b[p];
        break;
      case OP_FLOAD:
        if (d > 0) { UNROLL_P st.at(d - 1, p) = acc[p]; }
        rd.load_found(prog_at(arg), prog_at(arg + 1), prog_at(arg + 2),
                      prog_at(arg + 3), lvl, acc);
        pc += 4;
        break;
      case OP_SEARCH:
        rd.search(prog_at(arg), prog_at(arg + 1), prog_at(arg + 2), acc,
                  lvl);
        if (d >= 2) { UNROLL_P acc[p] = st.at(d - 2, p); }
        pc += 3;
        break;
      case OP_STORE:
        rd.store(prog_at(arg), acc, klo, khi);
        if (d >= 2) { UNROLL_P acc[p] = st.at(d - 2, p); }
        pc += 1;
        break;
      case OP_KEEP:
        UNROLL_P st.at(d - 1, p) = acc[p];
        break;
      case OP_DROP:  // the top stays in acc: nothing moves
        pc += 1;
        break;
      UNARY(OP_NEG, NEG_OF) UNARY(OP_SQRT, sqrtf) UNARY(OP_ABS, fabsf)
      UNARY(OP_EXP, expf) UNARY(OP_LOG, logf) UNARY(OP_SIGN, sign_of)
      UNARY(OP_FLOOR, floorf)
      case OP_WHERE:
        UNROLL_P acc[p] = st.at(d - 3, p) != 0.f ? st.at(d - 2, p) : acc[p];
        break;
      default:
        __trap();  // a word the encoder never writes
    }
  }
}

// Copy the launch's tables into dynamic shared memory (Tables' layout):
// the records and ops and the constants from device memory, the slot table
// and the parameters from the kernel parameter.
template <int kWords>
__device__ __forceinline__ Tables stage(const LaunchArgs<kWords>& a) {
  const LaunchHeader& h = a.h;
  const Tables t(h);
  int* prog = reinterpret_cast<int*>(dynamic_smem);
  for (int x = threadIdx.x; x < h.n_prog; x += blockDim.x) prog[x] = h.prog[x];
  unsigned long long* table =
      reinterpret_cast<unsigned long long*>(dynamic_smem + t.ptr);
  for (int x = threadIdx.x; x < t.param_words(); x += blockDim.x)
    table[x] = a.table[x];
  for (int x = threadIdx.x; x < h.n_consts; x += blockDim.x)
    dynamic_smem[t.consts + x] = h.consts[x];
  __syncthreads();
  return t;
}

// K1: a launch group of PARALLEL statements (replaces _horizontal_kernel).
// One thread per (member chunk, tile, K span, j, i): it walks the span's
// levels in strips of P and runs every record of the group on each strip,
// in order, each masked by its box and levels.
// At least 4 CTAs an SM: at most 128 registers a thread.  Left to its
// own choice, ptxas gave the member instance 80 registers and spilled.
template <bool kMembers, int P, int kWords>
__global__ void __launch_bounds__(K1_BLOCK, 4)
    stencil_parallel_kernel(const __grid_constant__ LaunchArgs<kWords> args) {
  const Tables s = stage(args);
  const LaunchHeader& a = args.h;
  const long long ni = a.i1 - a.i0, nj = a.j1 - a.j0;
  const int nspan = (a.khi - a.klo + a.kspan - 1) / a.kspan;
  const long long nchunk = kMembers ? a.nmember / a.mchunk : 1;
  long long g = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (g >= nchunk * a.ntile * nspan * nj * ni) return;
  const int i = a.i0 + static_cast<int>(g % ni); g /= ni;
  const int j = a.j0 + static_cast<int>(g % nj); g /= nj;
  const int span = static_cast<int>(g % nspan); g /= nspan;
  const int t = kMembers ? static_cast<int>(g % a.ntile) : static_cast<int>(g);
  const int chunk = kMembers ? static_cast<int>(g / a.ntile) : 0;
  const int kbeg = a.klo + span * a.kspan;
  const int kend = min(kbeg + a.kspan, a.khi);
  const int n_rec = prog_at(0);
  const int mchunk = kMembers ? a.mchunk : 1;
  const Stack<P> st{dynamic_smem + s.words + threadIdx.x,
                    static_cast<int>(blockDim.x)};
  float acc[P];
  int lvl[P];
#pragma unroll
  for (int p = 0; p < P; ++p) { acc[p] = 0.f; lvl[p] = 0; }
  for (int mm = 0; mm < mchunk; ++mm) {
    const int m = chunk * mchunk + mm;
    for (int k0 = kbeg; k0 < kend; k0 += P) {
      StripReader<kMembers, P> rd{s, m, t, j, i, k0, a.jp, a.ip};
      for (int q = 0; q < n_rec; ++q) {
        const int r = 1 + REC_INTS * q;
        // the record's levels and box, read at once, tested without a
        // branch per bound
        const int klo = prog_at(r + 1), khi = prog_at(r + 2),
                  j0 = prog_at(r + 3), j1 = prog_at(r + 4),
                  i0 = prog_at(r + 5), i1 = prog_at(r + 6);
        if ((k0 + P <= klo) | (k0 >= khi) | (j < j0) | (j >= j1) | (i < i0) |
            (i >= i1))
          continue;
        run_ops<P>(s, prog_at(r + 7), prog_at(r + 8), rd, st, acc, lvl, klo,
                   khi);
      }
    }
  }
}

// a 4-byte copy from device memory into shared memory that completes
// asynchronously (cp.async), in the thread's current commit group
__device__ __forceinline__ void copy_async(int dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   static_cast<uint32_t>(
                       __cvta_generic_to_shared(dynamic_smem + dst))),
               "l"(src)
               : "memory");
}

// K2 and K4: the column march.  One thread per P neighbouring columns
// (member chunk, tile, rows j .. j + P - 1, i): it marches k over [lo, hi)
// and runs the records at each level for its P columns at once (one decode
// per op for P chains), each record masked by its levels and, per column,
// by its box.  Reads of the marching-previous level of a carried slot come
// from the carry (ColumnReader), which starts empty for each member.  The
// keys of the ahead table are copied into shared memory by cp.async while
// the march runs, one commit group per G levels, double-buffered: at the
// first level of a group the next group's copies (the next member's first
// at a member's last) are issued and this group's are waited for, so a
// level's loads wait on no device memory.  K2 (kBlocked false): G = 1, a
// level ahead.  K4: G = bk levels (cuda.py's copy_depth), and its march
// spans [0, nk): the marching-previous level of its first level lies
// outside every slot's K extent, and there K4 reads 0, the reference's
// carry zeroed at each member's first slab (the carry's entries of that
// level zeroed and marked held, and the copies of the AHEAD keys at that
// level zeroed; the encoder leaves no other read there).
template <bool kMembers, int P, bool kBlocked, int kWords>
__device__ __forceinline__ void march_columns(
    const LaunchArgs<kWords>& args) {
  static_assert(P <= 4, "K4 packs a record's columns in 4 bits");
  const Tables s = stage(args);
  const LaunchHeader& a = args.h;
  const int nthr = blockDim.x, tid = threadIdx.x;
  const long long ni = a.i1 - a.i0, njg = (a.j1 - a.j0 + P - 1) / P;
  const long long nchunk = kMembers ? a.nmember / a.mchunk : 1;
  long long g = static_cast<long long>(blockIdx.x) * nthr + tid;
  if (g >= nchunk * a.ntile * njg * ni) return;
  const int i = a.i0 + static_cast<int>(g % ni); g /= ni;
  const int j = a.j0 + P * static_cast<int>(g % njg); g /= njg;
  const int t = kMembers ? static_cast<int>(g % a.ntile) : static_cast<int>(g);
  const int chunk = kMembers ? static_cast<int>(g / a.ntile) : 0;
  int joff[P];  // row j + p's column, from row j's
#pragma unroll
  for (int p = 0; p < P; ++p) joff[p] = (min(j + p, a.j1 - 1) - j) * a.ip;
  const int n_stmts = prog_at(0);
  const int mchunk = kMembers ? a.mchunk : 1;
  const int nkey = (a.ahead_end - a.ahead_begin) / 4;
  const int n_steps = a.hi - a.lo;
  const int first = a.forward ? a.lo : a.hi - 1, dir = a.forward ? 1 : -1;
  const int G = kBlocked ? a.bk : 1;  // levels of a copy group
  const int n_groups = (n_steps + G - 1) / G;
  // dynamic_smem, after the tables: the stack [depth][P], the carry
  // [carried][2][P], the copies [2][G][nkey][P], each [..][thread], then
  // the column table [slot][thread] (pointers, 8-byte aligned: nthr is
  // even)
  const SharedStack<P> st{s.words + tid, nthr};
  const int cv = s.words + a.depth * P * nthr + tid;
  const int copies = cv + 2 * a.n_carried * P * nthr;
  const int level_words = nkey * P * nthr;  // one level of copies
  float** table = reinterpret_cast<float**>(
      dynamic_smem + s.words + (a.depth + 2 * a.n_carried) * P * nthr +
      2 * G * level_words);
  for (int slot = 0; slot < a.n_slots; ++slot)
    table[slot * nthr + tid] = column<false>(s, slot, 0, t, a.jp, a.ip, j, i);
  float* const* cols = table + tid;
  // the ahead table's keys at the levels of group grp of member m into
  // buffer buf, as one commit group (an empty one past the chunk's last
  // level)
  auto copy_group = [&](bool any, int m, int grp, int buf) {
    if (any) {
      const int s0 = grp * G, s1 = min(s0 + G, n_steps);
      for (int step = s0; step < s1; ++step) {
        const int k = first + dir * step;
        const int at = copies + (buf * G + step - s0) * level_words;
        for (int x = 0; x < nkey; ++x) {
          const int key = a.ahead_begin + 4 * x;  // slot di dj dk
          const float* c = cell<kMembers>(
              s, cols, nthr, prog_at(key), m, a.jp, a.ip, prog_at(key + 1),
              prog_at(key + 2), k + prog_at(key + 3));
#pragma unroll
          for (int p = 0; p < P; ++p)
            copy_async(at + (x * P + p) * nthr, c + joff[p]);
        }
      }
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  // the march of the copies runs a group ahead of the interpreter's
  int c_mm = 0, c_grp = 0, c_buf = 0;
  auto copy_next = [&]() {
    copy_group(c_mm < mchunk, chunk * mchunk + c_mm, c_grp, c_buf);
    c_buf ^= 1;
    if (++c_grp == n_groups) {
      c_grp = 0;
      ++c_mm;
    }
  };
  if (nkey > 0) copy_next();
  float acc[P];
  int lvl[P];
#pragma unroll
  for (int p = 0; p < P; ++p) { acc[p] = 0.f; lvl[p] = 0; }
  // one level of the march: the records at level first + dir * step of
  // member m, this level's copies at ``ahead``.  K4 decides per copy
  // group which of the first 32 records no level of the group runs for
  // this thread (``skip``), and which of the first 8 run at every level,
  // with their columns (``sure``, ``lives``: 4 bits each)
  auto level = [&](int m, int step, int ahead, unsigned& cur, unsigned skip,
                   unsigned sure, unsigned lives) {
    const int k = first + dir * step;
    ColumnReader<kMembers, P> rd{s,    m,     k,    a.jp, a.ip, cols, {}, 0u,
                                 cv,   ahead, nthr, 0u,   cur};
#pragma unroll
    for (int p = 0; p < P; ++p) rd.joff[p] = joff[p];
    for (int q = 0; q < n_stmts; ++q) {
      const int r = 1 + REC_INTS * q;
      unsigned live = 0;
      if (q < 8 && ((sure >> q) & 1u)) {
        live = (lives >> (4 * q)) & 15u;
      } else {
        if (q < 32 && ((skip >> q) & 1u)) continue;
        // the record's levels and box, read at once, tested without a
        // branch per bound
        const int rk0 = prog_at(r + 1), rk1 = prog_at(r + 2),
                  ri0 = prog_at(r + 5), ri1 = prog_at(r + 6);
        if ((k < rk0) | (k >= rk1) | (i < ri0) | (i >= ri1)) continue;
        const int rj0 = prog_at(r + 3), rj1 = prog_at(r + 4);
#pragma unroll
        for (int p = 0; p < P; ++p)
          live |= static_cast<unsigned>(j + p >= rj0 && j + p < rj1 &&
                                        j + p < a.j1) << p;
        if (live == 0) continue;
      }
      rd.live = live;
      run_ops<P>(s, prog_at(r + 7), prog_at(r + 8), rd, st, acc, lvl,
                 prog_at(r + 1), prog_at(r + 2));
    }
    cur = rd.cur;
  };
  int buf = 1;
  for (int mm = 0; mm < mchunk; ++mm) {
    const int m = chunk * mchunk + mm;
    unsigned cur = 0;  // the carry starts empty for each member
    if constexpr (!kBlocked) {
      for (int step = 0; step < n_steps; ++step) {
        if (nkey > 0) {
          copy_next();
          // this level's copies are done (the next level's may still run)
          asm volatile("cp.async.wait_group 1;" ::: "memory");
        }
        buf ^= 1;
        level(m, step, copies + buf * level_words, cur, 0u, 0u, 0u);
      }
      continue;
    }
    // K4: zeroed, and held for the level before the first
    const int before = first - dir;
    for (int c = 0; c < a.n_carried; ++c) {
#pragma unroll
      for (int p = 0; p < P; ++p)
        dynamic_smem[cv + ((c * 2 + (before & 1)) * P + p) * nthr] = 0.f;
    }
    cur = a.n_carried * P >= 32 ? ~0u : (1u << (a.n_carried * P)) - 1u;
    for (int s0 = 0; s0 < n_steps; s0 += G) {  // a copy group's levels
      if (nkey > 0) {
        copy_next();
        // this group's copies are done (the next group's may still run)
        asm volatile("cp.async.wait_group 1;" ::: "memory");
      }
      buf ^= 1;
      int ahead = copies + buf * G * level_words;
      if (s0 == 0) {  // the first level's keys a level up
        for (int x = 0; x < nkey; ++x) {
          if (prog_at(a.ahead_begin + 4 * x + 3) == 0) continue;
#pragma unroll
          for (int p = 0; p < P; ++p)
            dynamic_smem[ahead + (x * P + p) * nthr] = 0.f;
        }
      }
      const int s1 = min(s0 + G, n_steps);
      // the records no level of the group runs, and those every level
      // runs, for this thread
      const int ka = first + dir * s0, kb = first + dir * (s1 - 1);
      const int klo = min(ka, kb), khi = max(ka, kb) + 1;
      unsigned skip = 0, sure = 0, lives = 0;
      for (int q = 0; q < min(n_stmts, 32); ++q) {
        const int r = 1 + REC_INTS * q;
        const int rk0 = prog_at(r + 1), rk1 = prog_at(r + 2),
                  rj0 = prog_at(r + 3), rj1 = prog_at(r + 4),
                  ri0 = prog_at(r + 5), ri1 = prog_at(r + 6);
        unsigned live = 0;
#pragma unroll
        for (int p = 0; p < P; ++p)
          live |= static_cast<unsigned>((j + p >= rj0) & (j + p < rj1) &
                                        (j + p < a.j1)) << p;
        const bool out = (i < ri0) | (i >= ri1) | (live == 0);
        skip |= static_cast<unsigned>(out | (khi <= rk0) | (klo >= rk1)) << q;
        if (q < 8 && !out && klo >= rk0 && khi <= rk1) {
          sure |= 1u << q;
          lives |= live << (4 * q);
        }
      }
      for (int step = s0; step < s1; ++step, ahead += level_words)
        level(m, step, ahead, cur, skip, sure, lives);
    }
  }
}

// K2: a FORWARD/BACKWARD computation (replaces _vertical_kernel).  At
// least one CTA an SM in the launch bounds: left to its own choice, ptxas
// gave the P = 4 instances under 100 registers and spilled.
template <bool kMembers, int P, int kWords>
__global__ void __launch_bounds__(K2_BLOCK, 1)
    stencil_column_kernel(const __grid_constant__ LaunchArgs<kWords> a) {
  march_columns<kMembers, P, false>(a);
}

// K4: a single-direction solver under a K-blocked schedule (replaces
// _vertical_kernel_kblocked and _compile_kblocked): K2's march over the
// interleaved statements, a slab of copies ahead.
template <bool kMembers, int P, int kWords>
__global__ void __launch_bounds__(K2_BLOCK, 1)
    stencil_kblocked_kernel(const __grid_constant__ LaunchArgs<kWords> a) {
  march_columns<kMembers, P, true>(a);
}

// One launch of ``kernel`` over ``n`` threads with ``bytes`` of dynamic
// shared memory (above the default 48 KB only after raising the kernel's
// cap), its parameter the header and the launch's table.
template <int kWords, class Kernel>
static int launch(Kernel kernel, long long n, int threads, size_t bytes,
                  cudaStream_t st, const LaunchHeader* h, const void* table) {
  if (bytes > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (bytes > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  LaunchArgs<kWords> a;
  a.h = *h;
  memcpy(a.table, table, Tables(*h).param_words() * sizeof(a.table[0]));
  const unsigned int blocks =
      static_cast<unsigned int>((n + threads - 1) / threads);
  kernel<<<blocks, threads, bytes, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// K1: the tables, then the stack [depth][K1_STRIP][thread]
template <int kWords>
static int launch_parallel(const LaunchHeader* h, const void* table,
                           long long n, cudaStream_t st) {
  const size_t bytes =
      (Tables(*h).words +
       static_cast<size_t>(h->depth) * K1_STRIP * K1_BLOCK) *
      sizeof(float);
  return h->nmember > 1
             ? launch<kWords>(stencil_parallel_kernel<true, K1_STRIP, kWords>,
                              n, K1_BLOCK, bytes, st, h, table)
             : launch<kWords>(stencil_parallel_kernel<false, K1_STRIP, kWords>,
                              n, K1_BLOCK, bytes, st, h, table);
}

// K2 and K4: the tables, the stack, the carry and two groups of copies (G
// levels each: K2 1, K4 h.bk) in shared memory, each
// [..][K2_COLS][thread], then the column table
template <bool kBlocked, int kWords>
static int launch_column(const LaunchHeader* h, const void* table,
                         cudaStream_t st) {
  constexpr int P = K2_COLS;
  const long long njg = (h->j1 - h->j0 + P - 1) / P;
  const long long n = static_cast<long long>(h->nmember / h->mchunk) *
                      h->ntile * njg * (h->i1 - h->i0);
  const size_t G = kBlocked ? h->bk : 1;
  const size_t bytes =
      (Tables(*h).words +
       (static_cast<size_t>(h->depth + 2 * h->n_carried) +
        2 * G * ((h->ahead_end - h->ahead_begin) / 4)) *
           P * K2_BLOCK) *
          sizeof(float) +
      static_cast<size_t>(h->n_slots) * K2_BLOCK * sizeof(float*);
  if (kBlocked)
    return h->nmember > 1
               ? launch<kWords>(stencil_kblocked_kernel<true, P, kWords>, n,
                                K2_BLOCK, bytes, st, h, table)
               : launch<kWords>(stencil_kblocked_kernel<false, P, kWords>, n,
                                K2_BLOCK, bytes, st, h, table);
  return h->nmember > 1
             ? launch<kWords>(stencil_column_kernel<true, P, kWords>, n,
                              K2_BLOCK, bytes, st, h, table)
             : launch<kWords>(stencil_column_kernel<false, P, kWords>, n,
                              K2_BLOCK, bytes, st, h, table);
}

// the instance whose kernel parameter holds the launch's table
template <bool kBlocked>
static int launch_column_sized(const LaunchHeader* h, const void* table,
                               cudaStream_t st) {
  const int words = Tables(*h).param_words();
  if (words <= TABLE_SMALL)
    return launch_column<kBlocked, TABLE_SMALL>(h, table, st);
  if (words <= TABLE_LARGE)
    return launch_column<kBlocked, TABLE_LARGE>(h, table, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

static bool column_args_ok(const LaunchHeader* h) {
  return h->n_carried <= CARRY_MAX && h->ahead_begin <= h->ahead_end &&
         h->ahead_end <= h->n_prog &&
         h->ahead_end - h->ahead_begin <= 4 * AHEAD_MAX;
}

extern "C" {

// Layout checks for the ctypes mirror of LaunchHeader and of Tables.
int stencil_header_size() { return static_cast<int>(sizeof(LaunchHeader)); }

int stencil_table_words(int n_prog, int n_slots, int n_params,
                        int n_consts) {
  LaunchHeader h{};
  h.n_prog = n_prog;
  h.n_slots = n_slots;
  h.n_params = n_params;
  h.n_consts = n_consts;
  return Tables(h).words;
}

int stencil_limits(int* out) {
  out[0] = REC_INTS; out[1] = OPW; out[2] = OP_SHIFT; out[3] = SRC_SHIFT;
  out[4] = SRC2_SHIFT; out[5] = K1_STRIP; out[6] = K1_BLOCK;
  out[7] = CARRY_MAX; out[8] = AHEAD_MAX; out[9] = K2_COLS;
  out[10] = K2_BLOCK; out[11] = SMEM_MAX; out[12] = TABLE_SMALL;
  out[13] = TABLE_LARGE;
  return 0;
}

// Each launch takes the header and the table of slots and parameters
// (Tables' layout from Tables::ptr on, Tables::param_words() 8-byte words).
// A launch over more than one member takes the kernels' member axis (K5).
int launch_stencil_parallel(const LaunchHeader* h, const void* table,
                            void* stream) {
  if (h->kspan <= 0 || h->kspan % K1_STRIP != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long nspan = (h->khi - h->klo + h->kspan - 1) / h->kspan;
  const long long n = static_cast<long long>(h->nmember / h->mchunk) *
                      h->ntile * nspan * (h->j1 - h->j0) * (h->i1 - h->i0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int words = Tables(*h).param_words();
  if (words <= TABLE_SMALL)
    return launch_parallel<TABLE_SMALL>(h, table, n, st);
  if (words <= TABLE_LARGE)
    return launch_parallel<TABLE_LARGE>(h, table, n, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

int launch_stencil_column(const LaunchHeader* h, const void* table,
                          void* stream) {
  if (!column_args_ok(h)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_column_sized<false>(h, table,
                                    static_cast<cudaStream_t>(stream));
}

// K4: bk, the levels of a copy group, is the slab or fewer (cuda.py's
// copy_depth keeps two groups within the budget of four CTAs an SM).
int launch_stencil_kblocked(const LaunchHeader* h, const void* table,
                            void* stream) {
  if (!column_args_ok(h) || h->bk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_column_sized<true>(h, table,
                                   static_cast<cudaStream_t>(stream));
}

const char* stencil_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
