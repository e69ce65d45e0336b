// Hand-written Hopper kernels of the LM serving and training paths
// (repro_torch/kernels/ops.py, called by repro_torch/models/; under
// autograd the Functions of kernels/flash_attention.py and rmsnorm.py):
//
//   flash_attention_wgmma_kernel (bf16),
//   flash_attention_fwd_kernel (f32)
//                              <- src/repro/kernels/flash_attention.py
//                                 _kernel (:21-54)                      K8
//   rmsnorm_kernel<.., false>  <- src/repro/kernels/rmsnorm.py
//                                 _kernel (:17-22)                      K9
//   rmsnorm_kernel<.., true>   <- same file, _kernel_residual (:25-32)  K9
//   ssm_state_scan_kernel      <- src/repro/kernels/ssm_scan.py
//                                 _kernel (:23-32)                      K10
//   flash_attention_bwd_*, rmsnorm_bwd_*, ssm_state_scan_bwd_kernel
//                              <- none: the backward of K8, K9 and K10
//                                 (the reference differentiates its jnp
//                                 and its lax.scan)
//
// K8, causal attention over the whole prompt, forward, with GQA, an
// optional tanh softcap and an optional sliding window.  q is (B, S, H, D)
// and k/v are (B, S, KVH, D), contiguous, read in that layout (the
// reference transposes to (B*H, S, D) first; here the kernels address
// (b, h) themselves).  Query head h reads kv head h / (H / KVH), as the
// reference's _repeat_kv orders them; masked scores are -1e30 (not -inf),
// l is clamped at 1e-20.
// The window (window > 0; Gemma-2's local layers, models/layers.py:157-159
// of the reference, whose Pallas kernel has none): key k is visible to
// query q iff q - window < k <= q.  A query tile of rows q0 .. q0 + BQ - 1
// walks the key tiles from max(0, q0 - window + 1) / BK up to its causal
// frontier, so tiles wholly below the window are neither loaded nor
// computed, and masks, after the softcap, every tile that holds a key past
// a row (the diagonal) or at or below a row's window edge.  A row can have
// every key of its first tiles masked: the softmax then gives those keys
// p = 0 (its running max is still -1e30) where the reference's online
// softmax gives them p = 1 and wipes them with alpha = 0 at its first real
// score; both end with exactly the keys of the window.  Each kernel is
// instantiated with and without the window (kWindow): window 0, or one of
// S keys or more, runs the causal instance, the code (and so the bits and
// the time) of the kernel before the window.
// Two instances:
//
// bfloat16, flash_attention_wgmma_kernel (the serving path).  Bound: at
// Granite-8B's prefill (B=8, S=2048, H=32, KVH=8, D=128) the 2.75e11
// causal flops over the tensor cores' 989 TFLOP/s (0.278 ms), not its
// 335 MB.  So both products run on the tensor cores with wgmma, and the
// design keeps them fed:
//  - Warp specialisation: a CTA of 3 warpgroups, two consumers of 64 query
//    rows each (240 registers a thread after setmaxnreg) and one producer
//    (24), one CTA per SM.  It is persistent: it walks query tiles of 128
//    rows in pairs (nq - 1 - i, i) of one (b, h), which need the same
//    number of key tiles whatever i (without a window), so a static
//    stride over pairs balances the SMs (the f32 kernel's order, one CTA
//    per query tile with the longest rows first, would idle each CTA at
//    its start and end).
//  - Loads: one producer thread issues TMA loads (cp.async.bulk.tensor),
//    one per 64 columns, into the 128-byte swizzle that wgmma reads.  Q has
//    two buffers (one at DP = 256), so the next query tile's Q loads a tile
//    ahead; K and V go through a ring of 2 stages.  Full and empty
//    mbarriers (bytes landed; all 256 consumer threads done) synchronise
//    them, with no __syncthreads in the key loop.  The tensor maps are
//    rank 4 over (D, heads, S, B): rows past S and columns past D are
//    zero-filled by the hardware instead of being read from the next batch
//    or head, so every D of HEAD_DIMS runs on tiles of a padded width DP
//    (64, 128 or 256).
//  - S = Q K^T: wgmma m64 nBK k16 from shared memory (K-major Q and K) over
//    D / 16 steps (D rounded up to 64 below 64), in f32, then multiplied by
//    1/sqrt(D), as the reference's model scales after the product
//    (layers.py:154-155; q is never rounded after scaling).  The scale is
//    folded into the exponent: exp(s - m) = 2^(raw c - m c), c = scale
//    log2 e, one FFMA and one MUFU.EX2 a score.  The softcap (tanh from
//    ex2 and rcp), the mask (on the diagonal and window-edge tiles only)
//    and the online softmax (m, l) stay in f32 registers.
//  - O += P V: P is rounded to bf16 in registers, where the S accumulator's
//    layout already is the A fragment; wgmma m64 nD k16 (n96 and n112 at
//    those widths, not the padded 128) with V read from shared memory in
//    its MN-major (transposed) form.  l sums the unrounded P.  That
//    rounding of P follows the reference model, which casts its
//    probabilities to bf16 before P V (layers.py:161); the Pallas kernel
//    keeps them in f32.
//  - Overlap: each key tile's P V is issued with the next tile's Q K^T
//    (its own wgmma fence, so ptxas keeps both asynchronous), and the
//    next softmax runs while P V is on the tensor cores; the two consumer
//    warpgroups take turns on the tensor cores (named barriers 1 and 2), so
//    one's softmax runs under the other's products; a query tile's last P V
//    is issued with the next query tile's first Q K^T.
//  - Epilogue: O / max(l, 1e-20) (one division a row, then products),
//    rounded once to bf16 into a swizzled staging buffer in shared memory
//    and written by TMA stores, which drop rows past S and columns past D.
//    (Stores straight from the accumulator layout, 16 bytes a row per
//    instruction, cost more than a key tile per query tile.)
// Keys per tile BK = 128 (64 at DP = 256, to keep O and S in registers).
// Shared memory at DP = 128: Q 2 x 32 KB, K/V ring 4 x 32 KB, O staging
// 2 x 16 KB (225 KB of the 227).
//
// float32, flash_attention_fwd_kernel (the parity path, held at rtol =
// atol = 2e-5).  One TF32 product keeps 11 of f32's 24 significand bits
// and misses that bar; three do not: each f32 operand x is split into
// hi = rna(x) and lo = rna(x - hi) (cvt.rna.tf32.f32, to nearest, ties
// away from zero) and a product is a_hi b_hi + a_hi b_lo + a_lo b_hi with
// f32 sums (lo lo, below 2^-22 of the product, is dropped): ~21 bits, as
// CUTLASS's 3xTF32 (OpMultiplyAddFastF32) computes f32 GEMMs.  The torch
// emulation of this arithmetic in tests/test_torch_lm_kernels.py meets the
// bar against the reference and one product misses it.  Bound: the causal
// flops three times over the tensor cores' 495 TFLOP/s TF32 (1.667 ms at
// Granite-8B's prefill shape, 1.458 at Zamba2-7B's D 112); the CUDA-core
// bound it replaced is the flops once over 67 TFLOP/s (4.10 ms).  What the
// design does about it:
//  - Tiles: one CTA per 64-row query tile of one (b, h), the longest rows
//    first; keys in tiles of 64 (32 at D 256).  Q, K and V live in shared
//    memory as TF32 hi and lo halves in the 128-byte swizzle wgmma reads,
//    K-major: Q and K as they are, V transposed (.tf32 wgmma takes no
//    transposed operand).  At D 128: Q 64 KB, a ring of 2 slots of 64 KB
//    (K_t in one, V_t in the other), 193 KB in all; 1 slot at D 256.
//  - Warp specialisation: a producer warpgroup loads each tile into
//    registers one ring item ahead (16 float4 a thread in flight, each
//    warp load 128 contiguous bytes a row), and once its slot is free
//    splits it and stores both halves (V transposed, its keys reordered so
//    P's accumulator layout is the A fragment), then arrives on the slot's
//    full mbarrier; the consumer warpgroup releases a slot on its empty
//    mbarrier as soon as its products are done.
//  - S = Q K^T: wgmma m64n64k8 .tf32, both operands from shared memory,
//    3 products a k8 step; q was scaled by 1/sqrt(D) in f32 before the
//    split, as the Pallas kernel scales it.  The online softmax in f32
//    registers (tanhf for a softcap, masked scores -1e30, exp as one FFMA
//    and one MUFU.EX2), l over the unrounded p.
//  - O += P V: P split in registers into the A fragments (wgmma RS),
//    V^T's hi and lo from shared memory, m64nNk8 (N = D, or 128 twice at
//    D 256), 3 products a step.
//  - The sums: the tensor cores round each sum they add to toward zero,
//    not to nearest, so an error that f32 adds leave random builds up,
//    the same sign every time.  Accumulated straight into O over the key
//    tiles, that made the kernel's rows 4-12x further from a float64
//    attention than the plain version's at S 2048 while inside the 2e-5
//    bar.  So each product sums the small cross terms first (into a small
//    sum, where a truncation is small) and the hi products last, and each
//    key tile's P V is summed apart and added to O in f32 registers,
//    rounded to nearest: the rows then land as close to float64 as the
//    plain version's.
//    (Issuing each tile's P V with the next tile's S, as the bf16 kernel
//    does, needs both tiles' registers: at D 112 to 256 ptxas then spills
//    and the kernel is slower.)
//  - Epilogue: O / max(l, 1e-20) stored from the accumulator as float2.
// The producer, not the tensor cores, limits it: every CTA loads and
// splits its key tiles again (a K/V tile serves 4 query heads x 32 query
// tiles at Granite's shape), and one warpgroup's loads and splits take
// longer than the consumer's products.  (A second producer warpgroup
// needs setmaxnreg, under which ptxas spills the consumer; three register
// buffers spill at D 112.)

// K8's backward: three launches, a memory-bound first one that reads O
// and dO once for delta = rowsum(dO O), then dK/dV and dQ.  The first is
// flash_attention_bwd_rows_kernel<T> in both dtypes (delta and the
// forward's lse laid out in 64-row tiles, below).
// Bound: S and dP recomputed and dV, dK and dQ are 5 products, 10 B H D
// flops a kept (query, key) pair: 6.875e11 at Granite-8B's training shape
// (8, 2048, 32/8, 128), 0.695 ms at 989 TFLOP/s bf16.  The design runs 7:
// dQ's kernel computes S and dP again rather than sum dQ over key tiles
// with float atomics, whose order, and so the bits, would change from run
// to run (a floor of 0.973 ms).  No atomics: the same inputs give the same
// bits.
//
// bfloat16, flash_attention_bwd_wgmma_{dkdv,dq}_kernel<DP, DN, kWindow>:
// every product on the tensor cores (wgmma, bf16 in, f32 sums), with the
// forward's machinery: TMA tiles (encode_bhsd's rank-4 maps, which
// zero-fill rows past S and columns past D, so every D of HEAD_DIMS runs
// on tiles padded to DP) in the 128-byte swizzle, mbarrier rings with no
// __syncthreads in the loops, two consumer warpgroups at 240 registers
// and a producer warpgroup at 24 (setmaxnreg), persistent CTAs that walk
// pairs of tiles of equal work (fa_next_tile), a causal and a window
// instance each:
//  - dK/dV, keys as the products' M: a CTA owns 128 keys of one (b, kv
//    head) (64 at DP 256), loads K and V once, and walks every query head
//    of the group in order, each from the key tile's causal start to the
//    window's upper edge, so the heads sum in registers in one fixed order.
//    Q and dO tiles of 64 rows come through a ring of 3 stages (2 at DP
//    256), and beside them their rows' lse and delta: one 512-byte bulk
//    copy (cp.async.bulk, issued by the producer's one thread on the same
//    full mbarrier) of the 64-row tile that flash_attention_bwd_rows_kernel
//    wrote.  That layout is why bf16 has a rows kernel of its own: lse
//    rows of a (b, h) start at (b H + h) S floats, and a TMA box or bulk
//    copy that starts off 16 bytes faults.  Per query tile:
//    S^T = K Q^T and dP^T = V dO^T (SS, both K-major), P^T = exp(s - lse)
//    (exp2 with log2 e folded in, after the softcap; 0 where hidden) and
//    dS^T = P^T (dP^T - delta) (1 - t^2) in f32 registers, both rounded to
//    bf16 where the accumulator's layout is the A fragment, then
//    dV += P^T dO and dK += dS^T Q (RS, dO and Q read MN-major, as the
//    forward reads V).  Registers at D 128: S^T 32, dP^T 32, dV 64 and dK
//    64 a thread.  At D 256 dK and dV of 64 keys would take 256, so each
//    warpgroup keeps 128 of the 256 columns of the same 64 keys and
//    computes S^T and dP^T itself, over all 256 columns: 1.5x the products
//    of the split, but the warpgroups never wait for each other.  Passing
//    P^T and dS^T through shared memory instead would add a handshake in
//    every tile, and their 16 KB: K, V, two ring stages and the dK/dV
//    staging already take 226 KB of the 227 there.  Key tiles pair
//    (nk - 1 - i, i): key tile 0 sees every query tile, the last one.
//  - dQ: the forward's CTA, 128 query rows of one (b, h) in two warpgroups
//    of 64, over key tiles of 64 keys (32 at DP 256, where Q and dO of 128
//    rows take 128 KB) from the window's lower edge to the causal frontier
//    through a ring of 4 stages (2 at DP 256); S = Q K^T and dP = dO V^T
//    (SS), dS in registers rounded to bf16 as the A fragment, dQ += dS K
//    (RS, K MN-major).  Registers at D 128: S 32, dP 32, dQ 64.  (Tiles of
//    128 keys, 192 a thread, made ptxas serialize the wgmma and spill.)
//    lse and delta of a thread's two rows, read once from the rows
//    kernel's tiles, stay in registers.
//  - Rows and keys past S: TMA zero-fills Q, dO, K and V there, but a row's
//    lse and delta would read another row's (or 0, and exp(s - 0) can
//    overflow into inf * 0): P is set to 0 for every row or key past S,
//    not only on the diagonal.
//  - Epilogue: dK and dQ scaled once by 1/sqrt(D), each gradient rounded
//    once to bf16 into a swizzled staging buffer and written by TMA
//    stores, which drop rows past S and columns past D.
//  - Numerics: dS is rounded to bf16 to enter wgmma, as FlashAttention 2
//    and 3 do; the plain version's bf16 branch rounds it too (after
//    forming it from the unrounded P, which it rounds before P^T dO as the
//    forward rounds it before P V).  dK and dV sum up to H / KVH x S rows
//    straight in the accumulator, whose adds truncate (see the f32
//    forward): some 2^-24 relative a k16 step, ~3e-5 over the 8192 rows
//    of Granite-8B's (8, 2048, 32/8) and ~6e-5 over the 16384 of its
//    training step's (4, 4096), far below the 2^-9 of their bf16
//    rounding; the rows against float64 in chip_smoke.py, held at both
//    shapes, land where the plain version's do.
// float32, flash_attention_bwd_tf32_{dkdv,dq}_kernel<D, kWindow> (the
// parity step, float32 training): every product on the tensor cores in
// 3xTF32, as the f32 forward (a_hi b_hi + a_hi b_lo + a_lo b_hi, f32
// sums).  Bound: 3 x the 5 products' flops over 495 TFLOP/s TF32, 4.167
// ms at Granite-8B's (8, 2048, 32/8, 128); the design runs 7 (dQ's
// kernel computes S and dP again), 5.834 ms.  .tf32 wgmma reads only
// K-major operands, so the B operands of the products that sum over the
// tile's rows or keys (dV += P^T dO, dK += dS^T Q, dQ += dS K) are
// transposed copies; an f32 tile in hi and lo is 4x a bf16 one (64 KB at
// 64 x 128), so K, V, Q, dO and the copies cannot all stay resident, and
// every tile splits its operands again.  What the design does about it:
//  - Loads: one producer thread (its warpgroup at 24 registers,
//    setmaxnreg) brings every operand raw by TMA into a ring of FB_DEPTH
//    stages: a pair item (one D chunk of 32 columns of both operands of an
//    SS product, 64 rows each; the A operand in the 128-byte swizzle), or
//    a transposed item (32 rows of the columns of an RS product's B), in
//    the order the products take them; with dK/dV's last pairs of a tile,
//    its 64 lse or delta (one bulk copy).  The maps zero-fill rows past S
//    and columns past D.
//  - Split: each consumer warpgroup (240 registers) splits its own items
//    into TF32 hi and lo: an SS product's A straight from the swizzled
//    stage into its A fragments in registers (wgmma RS), its B and the
//    transposed items into the 128-byte swizzle wgmma reads, in two slots
//    of the warpgroup's own in turn, the next item's split running under
//    the last one's products; transposed items with their rows of each
//    group of 8 in put_v's order 0 2 4 6 1 3 5 7, so an accumulator's
//    registers are the next product's A fragment.  The split rounds by
//    integer arithmetic (split_tf32_alu: the bits of cvt.rna, on pipes
//    four times its rate).  The split moves the data through shared
//    memory twice over, and that traffic, not the tensor cores, bounds
//    the kernels: A in registers skips its share.
//  - Work: two consumer warpgroups share each 64 x 64 tile: dK/dV (keys
//    as M): 0 runs S^T = K Q^T, P^T and dV += P^T dO, 1 runs dP^T = V dO^T,
//    dS^T and dK += dS^T Q; dQ: 0 runs S = Q K^T and P, 1 dP and dS, each
//    dQ += dS K over half of dQ's columns.  P dc and dS pass through 16 KB
//    exchange buffers in the accumulator's own layout (thread t reads what
//    thread t wrote), on mbarriers.
//  - Sums: the tensor cores truncate every sum they add to (see the f32
//    forward), so no sum on them spans more than 4 k8 steps: each chunk of
//    an SS product (cross terms first) and each 32-row half of an RS
//    product (and each half of its output columns past 64, to stay within
//    the registers) is a fresh sum, added to the running one in f32
//    registers, rounded to nearest.  Every sum runs in one fixed order,
//    without atomics: the same inputs give the same bits.
//  - Walks: dK/dV a CTA per 64 keys of a (b, kv head) (and per half of the
//    columns at D 256, where dK and dV of 64 keys x 256 would take 256
//    registers: both halves compute S^T and dP^T), every query head of
//    the group in order, from the key tile's causal start to the window's
//    upper edge, key tile 0 first; dQ a CTA per 64 query rows of a (b, h),
//    the last query tile first, key tiles from the window's lower edge.
//  - Epilogue: both consumer warpgroups done, their slots are free: each
//    stages its 64 rows (dK and dQ times 1/sqrt(D)) and writes them by
//    TMA stores (boxes that tile its columns).
// Shared memory: 4 slots of 32 KB, FB_DEPTH (4) stages of 16 KB and their
// 256-byte side buffers, 2 exchange buffers of 16 KB, barriers: 231,680
// bytes of the 232,448.  No instance spills (ptxas -v).
// The dispatch by dtype is explicit (launch_flash_attention_bwd).
//
// K9, RMSNorm with a (1 + w) scale over the last axis of (rows, d), in f32:
// o = x * (1 / sqrt(mean(x^2) + eps)) * (1 + w) in x's dtype; the residual
// variant sums s = x + r in f32, writes s rounded to x's dtype as the new
// residual and normalises the unrounded s, as _kernel_residual does.
// Bound by device memory: rmsnorm reads x and writes o (235 MB at 16384 x
// 3584 bf16, 0.070 ms at 3.35 TB/s), the residual variant reads two and
// writes two (0.140 ms); at a decode step's 8 rows, by the latency of one
// round trip to memory and one reduction.  So one CTA per row holds the
// row in registers between the sum of squares and the scale: x (and r) are
// read once, s is formed once, and every access moves 16 bytes (8 bf16 or
// 4 f32), neighbouring threads on neighbouring pieces.  The widths the
// served models give it (3584, 4096, 7168) are instances of their own: a
// thread holds the pieces at 1024 c + 8 t (bf16, 128 threads) or 1024 c +
// 4 t (f32, 256 threads), and at a decode step's few rows the weight's
// beside them, loaded with the row before the reduction (a prefill's rows
// load it after the reduction, from L1 and L2, and keep the registers for
// more rows in flight).  Any other d (d % 4 == 0) runs the general
// instance of the same kernel, 256 threads over pieces of 4 elements (8
// bytes in bf16: rows are only 8-byte aligned there) that reads the row a
// second time for the scale.  Every instance adds the squares in one
// order (cta_sum: 256 lanes of 4 elements at a stride of 1024, a shuffle
// tree a warp of lanes, 8 slots in turn), so they give the same bits as
// one another and as the kernel before them, which made those sums.
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
// version computes it; K8's f32 dot products call fmaf explicitly (and in
// its bf16 kernel exp2f((s - m) * log2 e) is two roundings).

#include <cuda.h>
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

// ---------------------------------------------------------------------------
// K8, bfloat16: wgmma, TMA and an mbarrier ring
// ---------------------------------------------------------------------------

// the bf16 kernel's tiles: DP is the padded head width (a multiple of the
// 64 columns of one 128-byte swizzle row)
template <int DP>
struct FaHopper {
  static constexpr int BQ = 128;                  // rows of a query tile
  static constexpr int BK = DP > 128 ? 64 : 128;  // keys per tile
  static constexpr int STAGES = 2;                // K/V ring depth
  static constexpr int NB = DP / 64;              // 64-column blocks
  static constexpr int QBUF = DP > 128 ? 1 : 2;   // Q buffers (by room)
  static constexpr int Q_BYTES = BQ * DP * 2;
  static constexpr int KV_BYTES = BK * DP * 2;    // one K or V tile
  // O leaves through shared memory: each consumer warpgroup stages its 64
  // rows, up to 128 columns at a time, for a TMA store
  static constexpr int O_COLS = DP > 128 ? 128 : DP;
  static constexpr int O_BYTES = 64 * O_COLS * 2;  // one warpgroup's
  static constexpr int THREADS = 3 * 128;  // 2 consumer WGs, 1 producer WG
  // Q, the K and V rings, the O staging, 1 KB of slack to align the
  // swizzled tiles, and the barriers
  static constexpr int SMEM = QBUF * Q_BYTES + 2 * STAGES * KV_BYTES +
                              2 * O_BYTES + 1024 + 256;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// wait until the barrier's phase of this parity has completed; a wait that
// outlasts 4 s (a lost arrival: a fault of the kernel, never a slow tile)
// traps, so the launch fails instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  uint64_t t0 = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) {
      t0 = global_ns();
    } else if (global_ns() - t0 > 4000000000ull) {
      __trap();
    }
  }
}

// one box of a rank-4 tensor map into shared memory, counted on `bar`
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// one box from shared memory into a rank-4 tensor map (elements outside
// the tensor are not written), tracked by the issuing thread's bulk group
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma matrix descriptor of a 128-byte-swizzled tile in shared memory:
// start address, leading and stride byte offsets (16-byte units), layout 1
// (SWIZZLE_128B)
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3fff) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3fff) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// wait until at most N committed wgmma groups are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// keep the compiler from moving reads or writes of wgmma's registers
// across the asynchronous instructions
template <int N>
__device__ __forceinline__ void wgmma_pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void wgmma_pin(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// the m64nN f32 accumulator, N/2 registers a thread: "+f" operands
// %0 .. %(N/2 - 1) (WG_D*) and their list in the instruction (WG_L*)
#define WG_F4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WG_F16(d, i) \
  WG_F4(d, i), WG_F4(d, i + 4), WG_F4(d, i + 8), WG_F4(d, i + 12)
#define WG_D4(d) WG_F4(d, 0)
#define WG_D8(d) WG_F4(d, 0), WG_F4(d, 4)
#define WG_D16(d) WG_F16(d, 0)
#define WG_D24(d) WG_F16(d, 0), WG_F4(d, 16), WG_F4(d, 20)
#define WG_D28(d) WG_D24(d), WG_F4(d, 24)
#define WG_D32(d) WG_F16(d, 0), WG_F16(d, 16)
#define WG_D48(d) WG_D32(d), WG_F16(d, 32)
#define WG_D56(d) WG_D48(d), WG_F4(d, 48), WG_F4(d, 52)
#define WG_D64(d) WG_D32(d), WG_F16(d, 32), WG_F16(d, 48)
#define WG_D128(d) \
  WG_D64(d), WG_F16(d, 64), WG_F16(d, 80), WG_F16(d, 96), WG_F16(d, 112)
#define WG_L4 "%0, %1, %2, %3"
#define WG_L8 WG_L4 ", %4, %5, %6, %7"
#define WG_L16 WG_L8 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define WG_L24 WG_L16 ", %16, %17, %18, %19, %20, %21, %22, %23"
#define WG_L28 WG_L24 ", %24, %25, %26, %27"
#define WG_L32 WG_L16 ", " \
  "%16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31"
#define WG_L48 WG_L32 ", " \
  "%32, %33, %34, %35, %36, %37, %38, %39, " \
  "%40, %41, %42, %43, %44, %45, %46, %47"
#define WG_L56 WG_L48 ", " \
  "%48, %49, %50, %51, %52, %53, %54, %55"
#define WG_L64 WG_L56 ", " \
  "%56, %57, %58, %59, %60, %61, %62, %63"
#define WG_L128 WG_L64 ", " \
  "%64, %65, %66, %67, %68, %69, %70, %71, " \
  "%72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, " \
  "%88, %89, %90, %91, %92, %93, %94, %95, " \
  "%96, %97, %98, %99, %100, %101, %102, %103, " \
  "%104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, " \
  "%120, %121, %122, %123, %124, %125, %126, %127"

// d += A B for one k16 step of a warpgroup, m64nN with NA = N/2
// accumulator registers; the later operands are numbered from NA on.
// WGMMA_SS reads A and B through descriptors (both K-major, operands a, b,
// scale_d); WGMMA_RS takes A from registers (4 x bf16x2 a thread, operands
// a[0..3]) and B, MN-major (transposed), through a descriptor (b), and
// always accumulates (the "r"(1) operand).
#define WGMMA_SS(N, NA, IA, IB, IS)                                       \
  asm volatile("{\n.reg .pred p;\n"                                      \
               "setp.ne.b32 p, %" #IS ", 0;\n"                           \
               "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" \
               WG_L##NA "}, %" #IA ", %" #IB ", p, 1, 1, 0, 0;\n}\n"      \
               : WG_D##NA(d)                                              \
               : "l"(a), "l"(b), "r"(scale_d))
#define WGMMA_RS(N, NA, I0, I1, I2, I3, IB, IS)                           \
  asm volatile("{\n.reg .pred p;\n"                                      \
               "setp.ne.b32 p, %" #IS ", 0;\n"                           \
               "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" \
               WG_L##NA "}, {%" #I0 ", %" #I1 ", %" #I2 ", %" #I3 "}, %" #IB \
               ", p, 1, 1, 1;\n}\n"                                      \
               : WG_D##NA(d)                                              \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int scale_d) {
  if constexpr (N == 32) {
    WGMMA_SS(32, 16, 16, 17, 18);
  } else if constexpr (N == 64) {
    WGMMA_SS(64, 32, 32, 33, 34);
  } else {
    static_assert(N == 128, "S tiles are 32, 64 or 128 keys");
    WGMMA_SS(128, 64, 64, 65, 66);
  }
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (N == 64) {
    WGMMA_RS(64, 32, 32, 33, 34, 35, 36, 37);
  } else if constexpr (N == 96) {
    WGMMA_RS(96, 48, 48, 49, 50, 51, 52, 53);
  } else if constexpr (N == 112) {
    WGMMA_RS(112, 56, 56, 57, 58, 59, 60, 61);
  } else if constexpr (N == 128) {
    WGMMA_RS(128, 64, 64, 65, 66, 67, 68, 69);
  } else {
    static_assert(N == 256, "head widths are 64, 96, 112, 128 or 256");
    WGMMA_RS(256, 128, 128, 129, 130, 131, 132, 133);
  }
}

// two floats rounded to nearest even into one bf16x2 (lo in the low half)
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

#define FA_LOG2E 1.4426950408889634f
// the exponent of a masked row's p (2^-inf = 0)
#define FA_MINUS_INF __uint_as_float(0xff800000u)

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// tanh(y) = sign(y) (1 - 2 / (2^(2 |y| log2 e) + 1)): two MUFU operations
// (tanhf is a long polynomial); absolute error ~1e-7
__device__ __forceinline__ float tanh_fast(float y) {
  const float t = ex2_approx(fabsf(y) * (2.f * FA_LOG2E));
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(t + 1.f));
  return copysignf(1.f - 2.f * r, y);
}

// register budgets of the warp-specialised kernel: the producer warpgroup
// gives back what the consumers take (24 x 128 + 240 x 256 <= 65536)
template <int R>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(R));
}

// the consumer warpgroups take turns on the tensor cores: warpgroup w
// waits on named barrier 1 + w (its turn, 256 threads: its own 128 and the
// other's arrival) before it issues its products, and then lets the other
// go; while one runs its products, the other runs its softmax
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;" ::"r"(1 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;" ::"r"(2 - wg) : "memory");
}

// the online softmax of one tile, in f32 registers: sc holds the raw
// scores Q K^T of rows r0 (even i / 2) and r0 + 8 (odd i / 2) at keys
// k0 + 8 (i / 4) + c2 + i % 2.  The scale is applied after the product:
// with a softcap, s = softcap tanh(raw scale / softcap); without, s = raw
// scale, folded into the exponent, exp(s - m) = 2^(raw c - m c) with
// c = scale log2 e (one FFMA).  m is kept in the units of sc.  Masked
// scores are -1e30: keys past the row and, with kWindow, keys at or below
// its window edge (key + window <= row), only on a tile that `edge` flags.
// With kWindow a row whose scores are all masked so far (m still -1e30)
// gets p = 0.  On return sc holds the unrounded p = exp(s - m_new), ls the
// row sums of this thread's p, alpha = exp(m_old - m_new).
template <int BK, bool kWindow>
__device__ __forceinline__ void softmax_tile(float (&sc)[BK / 2],
                                             float (&m)[2], float (&alpha)[2],
                                             float (&ls)[2], int k0, int r0,
                                             int c2, bool edge, int window,
                                             float scale, float softcap) {
  float c = scale * FA_LOG2E;
  if (softcap > 0.f) {
    const float to_cap = scale / softcap;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i)
      sc[i] = softcap * tanh_fast(sc[i] * to_cap);
    c = FA_LOG2E;
  }
  if (edge) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int key = k0 + 8 * (i / 4) + c2 + (i % 2);
      const int row = r0 + 8 * ((i / 2) % 2);
      if (key > row || (kWindow && key + window <= row)) sc[i] = -1e30f;
    }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i)
    mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
  float mc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // the 4 threads of a quad hold one row
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = ex2_approx((m[r] - mx[r]) * c);
    m[r] = mx[r];
    // every score so far masked (a row's first tiles under a window):
    // 2^(-inf) = 0 for each, where -mx c would leave the rounding error of
    // -1e30 c in the exponent
    mc[r] = kWindow && mx[r] == -1e30f ? FA_MINUS_INF : -mx[r] * c;
    ls[r] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const int r = (i / 2) % 2;
    sc[i] = ex2_approx(fmaf(sc[i], c, mc[r]));
    ls[r] += sc[i];
  }
}

// p rounded to bf16 pairs: the S layout of keys 16 kt .. 16 kt + 15 is the
// A fragment of the k16 step kt of P V
template <int BK>
__device__ __forceinline__ void pack_p(uint32_t (&p)[BK / 16][4],
                                       const float (&sc)[BK / 2]) {
#pragma unroll
  for (int i = 0; i < BK / 2; i += 2)
    p[i / 8][(i / 2) % 4] = pack_bf16x2(sc[i], sc[i + 1]);
}

// The j-th query tile of a CTA's walk: unit u = blockIdx.x + (j / 2)
// gridDim.x is the pair of query tiles (nq - 1 - i, i) of one (b, h), the
// longer first, so every unit needs the same number of key tiles (nq + 1
// at BK = BQ) and a static stride balances the CTAs.  Advances j past the
// missing twin of an odd count's middle tile; false past the last unit.
__device__ __forceinline__ bool fa_next_tile(int& j, int nq, int n_units,
                                             int H, int& b, int& h,
                                             int& qt) {
  const int pairs = (nq + 1) / 2;
  for (;; ++j) {
    const int u = blockIdx.x + (j / 2) * gridDim.x;
    if (u >= n_units) return false;
    const int i = u % pairs;
    if (j % 2 == 1 && 2 * i == nq - 1) continue;  // the middle tile
    b = u / pairs / H;
    h = u / pairs % H;
    qt = j % 2 == 0 ? nq - 1 - i : i;
    return true;
  }
}

// Persistent: one CTA per SM walks its query tiles (fa_next_tile).  The
// producer and the consumers walk the same sequence, and the ring's stage
// and phase count key tiles over all of a CTA's work: the next query
// tile's Q and K load while the consumers finish the last one, whose last
// P V is issued with the next tile's first Q K^T.  A query tile's key
// tiles run from key_lo (the window's lower edge; 0 without kWindow) to
// key_hi (the causal frontier).  Under a window the pairs (nq - 1 - i, i)
// no longer need equal work: at Gemma-2's prefill (S 6144, window 4096,
// B 4 x H 8 on 132 SMs) the busiest CTA walks 1.10x the mean of key tiles
// (1.03x without the window).  DN is D rounded up to the products' width
// (D itself from 96 up; 64 below): Q K^T runs DN / 16 k16 steps and P V is
// m64 nDN, over the DP-wide (zero-padded) tiles in shared memory.
template <int DP, int DN, bool kWindow>
__global__ void __launch_bounds__(FaHopper<DP>::THREADS, 1)
    flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                                 const __grid_constant__ CUtensorMap tk,
                                 const __grid_constant__ CUtensorMap tv,
                                 const __grid_constant__ CUtensorMap to,
                                 float* __restrict__ lse, int B, int S,
                                 int H, int KVH, int D, float scale,
                                 float softcap, int window) {
  using T = FaHopper<DP>;
  constexpr int BQ = T::BQ, BK = T::BK, ST = T::STAGES, NB = T::NB;
  constexpr int QB = T::QBUF;
  extern __shared__ uint8_t fa_raw[];
  // the swizzle repeats every 1024 bytes: every tile starts on a multiple
  const uint32_t sq = (smem_u32(fa_raw) + 1023) & ~1023u;  // Q [QB]
  const uint32_t sk = sq + QB * T::Q_BYTES;        // K ring
  const uint32_t sv = sk + ST * T::KV_BYTES;       // V ring
  const uint32_t so = sv + ST * T::KV_BYTES;       // O staging [2]
  const uint32_t q_full = so + 2 * T::O_BYTES;     // [QB] 8-byte barriers
  const uint32_t q_empty = q_full + 8 * QB;        // [QB]
  const uint32_t k_full = q_empty + 8 * QB;        // [ST] bytes landed
  const uint32_t v_full = k_full + 8 * ST;         // [ST]
  const uint32_t k_empty = v_full + 8 * ST;        // [ST] consumers done
  const uint32_t v_empty = k_empty + 8 * ST;       // [ST]

  const int nq = (S + BQ - 1) / BQ;  // query tiles of a head
  const int n_units = B * H * ((nq + 1) / 2);
  const int wg = threadIdx.x / 128;
  auto key_hi = [&](int qt) {  // up to the causal frontier
    return (min(qt * BQ + BQ, S) + BK - 1) / BK;
  };
  auto key_lo = [&](int qt) {  // from the window's lower edge
    return kWindow ? max(0, qt * BQ - window + 1) / BK : 0;
  };
  // keys k0 .. k0 + BK - 1 against a warpgroup's rows wq0 .. wq0 + 63: a
  // key past a row, or one at or below a row's window edge, to mask
  auto edge = [&](int k0, int wq0) {
    return k0 + BK - 1 > wq0 || (kWindow && k0 + window <= wq0 + 63);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < QB; ++s) {
      mbar_init(q_full + 8 * s, 1);
      mbar_init(q_empty + 8 * s, 2 * 128);
    }
    for (int s = 0; s < ST; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, 2 * 128);
      mbar_init(v_empty + 8 * s, 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one thread issues every load.  Per query tile: K_0 first
    // (its stage frees early), then Q into its buffer once the consumers
    // are done with the query tile that used it last (with two buffers, Q
    // loads a whole query tile ahead), then V_0, K_1, V_1, ...  A stage is
    // refilled once both consumer warpgroups released it.
    regs_dealloc<24>();
    if (threadIdx.x != 256) return;
    auto load_kv = [&](uint32_t ring, uint32_t full, uint32_t empty_bar,
                       const CUtensorMap* map, int g, int t, int kvh,
                       int b) {
      const int s = g % ST;
      if (g >= ST) mbar_wait(empty_bar + 8 * s, ((g / ST) - 1) & 1);
      mbar_expect_tx(full + 8 * s, T::KV_BYTES);
      for (int c = 0; c < NB; ++c)
        tma_load_4d(ring + s * T::KV_BYTES + c * BK * 128, map, full + 8 * s,
                    64 * c, kvh, t * BK, b);
    };
    int items = 0, tiles = 0, b, h, qt;
    for (int j = 0; fa_next_tile(j, nq, n_units, H, b, h, qt); ++j) {
      const int kvh = h / (H / KVH), lo = key_lo(qt);
      const int n_tiles = key_hi(qt) - lo, qb = items % QB;
      load_kv(sk, k_full, k_empty, &tk, tiles, lo, kvh, b);
      if (items >= QB) mbar_wait(q_empty + 8 * qb, ((items / QB) - 1) & 1);
      mbar_expect_tx(q_full + 8 * qb, T::Q_BYTES);
      for (int c = 0; c < NB; ++c)
        tma_load_4d(sq + qb * T::Q_BYTES + c * BQ * 128, &tq,
                    q_full + 8 * qb, 64 * c, h, qt * BQ, b);
      load_kv(sv, v_full, v_empty, &tv, tiles, lo, kvh, b);
      for (int t = 1; t < n_tiles; ++t) {
        load_kv(sk, k_full, k_empty, &tk, tiles + t, lo + t, kvh, b);
        load_kv(sv, v_full, v_empty, &tv, tiles + t, lo + t, kvh, b);
      }
      tiles += n_tiles;
      ++items;
    }
    return;
  }

  // consumers: warpgroup wg owns rows wq0 .. wq0 + 63 of a query tile;
  // this thread holds rows r0 and r0 + 8 of them, at columns
  // 8 j + c2 + {0, 1} of each n8 block j of an accumulator (wgmma's
  // m64 nN f32 layout)
  regs_alloc<240>();
  const int tid = threadIdx.x % 128;
  const int c2 = 2 * (tid % 4);
  uint32_t qa;  // this warpgroup's Q rows in the query tile's buffer
  float acc[DN / 2];
  float m[2], l[2];
  uint32_t p[BK / 16][4];

  // S = Q K^T of the tile in stage s over DN / 16 k16 steps: a step inside
  // a 128-byte row advances the start address by 32 bytes, a new 64-column
  // block by the block's rows x 128 bytes; 8-row groups are 1024 apart
  auto issue_s = [&](float (&sc)[BK / 2], int s) {
    const uint32_t kb = sk + s * T::KV_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DN / 16; ++kk) {
      const uint32_t a = qa + (kk / 4) * BQ * 128 + (kk % 4) * 32;
      const uint32_t bk = kb + (kk / 4) * BK * 128 + (kk % 4) * 32;
      wgmma_ss<BK>(sc, wgmma_desc(a, 16, 1024), wgmma_desc(bk, 16, 1024),
                   kk > 0);
    }
    wgmma_commit();
  };
  // O += P V of the tile in stage s over BK / 16 k16 steps: V is the B
  // operand in its MN-major form (D contiguous); 8-key groups are 1024
  // bytes apart (SBO), 64-column blocks BK x 128 bytes (LBO), a k16 step
  // 16 rows of 128 bytes.  Each product has its own fence: ptxas then
  // sees two pipeline stages, and reading S after wait<1> does not
  // serialise the P V products
  auto issue_pv = [&](int s) {
    const uint32_t vb = sv + s * T::KV_BYTES;
    wgmma_pin(acc);
    wgmma_pin(p);
    wgmma_fence();
#pragma unroll
    for (int kt = 0; kt < BK / 16; ++kt)
      wgmma_rs<DN>(acc, p[kt],
                   wgmma_desc(vb + kt * 16 * 128, BK * 128, 1024));
    wgmma_commit();
  };
  // O / max(l, 1e-20) of this warpgroup's rows wq0 .. wq0 + 63 of query
  // tile (b, h): one division a row, then products, rounded once into the
  // warpgroup's staging buffer (128-byte swizzle: the 8 rows of a store
  // hit distinct banks), then TMA stores of 64 columns each, which drop
  // rows >= S and columns >= D.  Up to 128 columns a pass (two at
  // DP = 256): a pass first waits until the previous stores have read the
  // buffer.  Named barrier 3 + wg syncs the warpgroup's 128 threads.
  const uint32_t so_wg = so + wg * T::O_BYTES;
  auto store_o = [&](int b, int h, int wq0) {
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = 1.f / fmaxf(l[r], 1e-20f);
    }
    // the rows' log-sum-exp for the backward (training only): m is in
    // the units of sc, so s = m (softcap) or m scale
    if (lse != nullptr && tid % 4 == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = wq0 + 16 * (tid / 32) + (tid % 32) / 4 + 8 * r;
        if (row < S)
          lse[(static_cast<long long>(b) * H + h) * S + row] =
              m[r] * (softcap > 0.f ? 1.f : scale) + logf(l[r]);
      }
    }
    constexpr int PASS = T::O_COLS / 8;  // n8 blocks a pass
#pragma unroll
    for (int pass = 0; pass < DN / 8; pass += PASS) {
      if (tid == 0)
        asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      asm volatile("bar.sync %0, 128;" ::"r"(3 + wg) : "memory");
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = 16 * (tid / 32) + (tid % 32) / 4 + 8 * r;
#pragma unroll
        for (int jj = 0; jj < PASS && pass + jj < DN / 8; ++jj) {
          const int j = pass + jj;
          const uint32_t dst = so_wg + (jj / 8) * 64 * 128 + row * 128 +
                               (((jj % 8) ^ (row % 8)) * 16) + c2 * 2;
          const uint32_t val = pack_bf16x2(acc[4 * j + 2 * r] * inv[r],
                                           acc[4 * j + 2 * r + 1] * inv[r]);
          asm volatile("st.shared.u32 [%0], %1;" ::"r"(dst), "r"(val)
                       : "memory");
        }
      }
      // the generic-proxy writes, seen by the TMA (async proxy)
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      asm volatile("bar.sync %0, 128;" ::"r"(3 + wg) : "memory");
      if (tid == 0) {
        for (int c = 0; c < T::O_COLS / 64 && 8 * pass + 64 * c < D; ++c)
          tma_store_4d(&to, so_wg + c * 64 * 128, 8 * pass + 64 * c, h, wq0,
                       b);
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      }
    }
  };

  // warpgroup 0 takes the first turn
  if (wg == 1) asm volatile("bar.arrive 1, 256;" ::: "memory");
  int j = 0, b, h, qt;
  if (fa_next_tile(j, nq, n_units, H, b, h, qt)) {
    int items = 0, tiles = 0;  // query tiles and key tiles walked before
    int qb = 0, wq0 = qt * BQ + 64 * wg;
    int r0 = wq0 + 16 * (tid / 32) + (tid % 32) / 4;
    int lo = key_lo(qt), n_tiles = key_hi(qt) - lo;
    // the first query tile's S_0 alone
    {
      float sc[BK / 2], alpha[2];
      qa = sq + wg * 64 * 128;
      mbar_wait(q_full, 0);
      mbar_wait(k_full, 0);
      turn_wait(wg);
      issue_s(sc, 0);
      turn_pass(wg);
      wgmma_wait<0>();
      wgmma_pin(sc);
      mbar_arrive(k_empty);
      m[0] = m[1] = -1e30f;
      softmax_tile<BK, kWindow>(sc, m, alpha, l, lo * BK, r0, c2,
                                edge(lo * BK, wq0), window, scale, softcap);
#pragma unroll
      for (int i = 0; i < DN / 2; ++i) acc[i] = 0.f;
      pack_p<BK>(p, sc);
    }
    for (;;) {
      // key tile t < n - 1: O += P_t V_t, issued with S_{t+1} = Q K_{t+1}^T,
      // whose softmax runs while P_t V_t is still on the tensor cores
      for (int t = 0; t + 1 < n_tiles; ++t) {
        const int g = tiles + t;
        const int s = g % ST, s1 = (g + 1) % ST;
        float sc[BK / 2], alpha[2], ls[2];
        mbar_wait(k_full + 8 * s1, ((g + 1) / ST) & 1);
        mbar_wait(v_full + 8 * s, (g / ST) & 1);
        turn_wait(wg);
        issue_s(sc, s1);
        issue_pv(s);
        turn_pass(wg);
        wgmma_wait<1>();  // S_{t+1} is done, P_t V_t may still run
        wgmma_pin(sc);
        mbar_arrive(k_empty + 8 * s1);
        const int k1 = (lo + t + 1) * BK;
        softmax_tile<BK, kWindow>(sc, m, alpha, ls, k1, r0, c2,
                                  edge(k1, wq0), window, scale, softcap);
        wgmma_wait<0>();
        wgmma_pin(acc);
        mbar_arrive(v_empty + 8 * s);
        l[0] = l[0] * alpha[0] + ls[0];
        l[1] = l[1] * alpha[1] + ls[1];
#pragma unroll
        for (int i = 0; i < DN / 2; ++i) acc[i] *= alpha[(i / 2) % 2];
        pack_p<BK>(p, sc);
      }
      // every product with this Q is done: its buffer may be refilled
      mbar_arrive(q_empty + 8 * qb);
      // the last key tile: its P V, issued with the next query tile's S_0
      const int g = tiles + n_tiles - 1, s = g % ST;
      int jn = j + 1, bn, hn, qtn;
      if (!fa_next_tile(jn, nq, n_units, H, bn, hn, qtn)) {
        mbar_wait(v_full + 8 * s, (g / ST) & 1);
        turn_wait(wg);
        issue_pv(s);
        turn_pass(wg);
        wgmma_wait<0>();
        wgmma_pin(acc);
        mbar_arrive(v_empty + 8 * s);
        store_o(b, h, wq0);
        break;
      }
      const int qbn = (items + 1) % QB, s1 = (g + 1) % ST;
      const int wq0n = qtn * BQ + 64 * wg, k0n = key_lo(qtn) * BK;
      const int r0n = wq0n + 16 * (tid / 32) + (tid % 32) / 4;
      float sc[BK / 2], alpha[2], mn[2] = {-1e30f, -1e30f}, ln[2];
      mbar_wait(q_full + 8 * qbn, ((items + 1) / QB) & 1);
      mbar_wait(k_full + 8 * s1, ((g + 1) / ST) & 1);
      mbar_wait(v_full + 8 * s, (g / ST) & 1);
      turn_wait(wg);
      qa = sq + qbn * T::Q_BYTES + wg * 64 * 128;
      issue_s(sc, s1);
      issue_pv(s);
      turn_pass(wg);
      wgmma_wait<1>();
      wgmma_pin(sc);
      mbar_arrive(k_empty + 8 * s1);
      softmax_tile<BK, kWindow>(sc, mn, alpha, ln, k0n, r0n, c2,
                                edge(k0n, wq0n), window, scale, softcap);
      wgmma_wait<0>();
      wgmma_pin(acc);
      mbar_arrive(v_empty + 8 * s);
      store_o(b, h, wq0);
#pragma unroll
      for (int i = 0; i < DN / 2; ++i) acc[i] = 0.f;
      m[0] = mn[0];
      m[1] = mn[1];
      l[0] = ln[0];
      l[1] = ln[1];
      pack_p<BK>(p, sc);
      j = jn;
      b = bn;
      h = hn;
      qt = qtn;
      qb = qbn;
      wq0 = wq0n;
      r0 = r0n;
      tiles += n_tiles;
      lo = key_lo(qt);
      n_tiles = key_hi(qt) - lo;
      ++items;
    }
  }
  // the staging buffers stay until the last stores have read them
  if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  // warpgroup 1's last turn_pass, so barrier 1 ends balanced
  if (wg == 0) asm volatile("bar.sync 1, 256;" ::: "memory");
}

// cuTensorMapEncodeTiled is a driver-API function: taken from the runtime
// at first use, so the library needs no -lcuda
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// error codes of the C interface beyond cudaError_t's (lm_error_string)
#define FA_NO_ENCODER (-1)
#define FA_ENCODE_FAILED (-2)

static EncodeTiledFn tensor_map_encoder() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// a bf16 (B, S, heads, D) tensor as a rank-4 map over (D, heads, S, B):
// boxes of 64 columns x 1 head x `rows` rows, 128-byte swizzle; loads read
// zeros outside the tensor, stores drop what falls outside it
static int encode_bhsd(EncodeTiledFn encode, CUtensorMap* map, const void* x,
                       int B, int S, int heads, int D, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {2ull * D, 2ull * D * heads,
                                 2ull * D * heads * S};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : FA_ENCODE_FAILED;
}

template <int DP, int DN>
static int launch_fa_wgmma(const void* q, const void* k, const void* v,
                           void* o, float* lse, int B, int S, int H,
                           int KVH, int D, float softcap, int window,
                           cudaStream_t stream) {
  using T = FaHopper<DP>;
  const EncodeTiledFn encode = tensor_map_encoder();
  if (encode == nullptr) return FA_NO_ENCODER;
  CUtensorMap tq, tk, tv, to;
  int rc = encode_bhsd(encode, &tq, q, B, S, H, D, T::BQ);
  if (rc == 0) rc = encode_bhsd(encode, &tk, k, B, S, KVH, D, T::BK);
  if (rc == 0) rc = encode_bhsd(encode, &tv, v, B, S, KVH, D, T::BK);
  if (rc == 0) rc = encode_bhsd(encode, &to, o, B, S, H, D, 64);
  if (rc != 0) return rc;
  // a window of S keys or more is no window: the causal instance
  auto kernel = window > 0 && window < S
                    ? flash_attention_wgmma_kernel<DP, DN, true>
                    : flash_attention_wgmma_kernel<DP, DN, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  // one CTA per SM (its shared memory and registers take the SM), each
  // walking units of two query tiles
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long units =
      static_cast<long long>(B) * H * (((S + T::BQ - 1) / T::BQ + 1) / 2);
  if (units > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(units < sms ? units : sms);
  kernel<<<grid, T::THREADS, T::SMEM, stream>>>(
      tq, tk, tv, to, lse, B, S, H, KVH, D,
      1.0f / sqrtf(static_cast<float>(D)), softcap, window);
  return static_cast<int>(cudaGetLastError());
}

static int dispatch_fa_wgmma(const void* q, const void* k, const void* v,
                             void* o, float* lse, int B, int S, int H,
                             int KVH, int D, float softcap, int window,
                             cudaStream_t stream) {
  switch (D) {
    case 16:
    case 32:
    case 64:
      return launch_fa_wgmma<64, 64>(q, k, v, o, lse, B, S, H, KVH, D, softcap,
          window, stream);
    case 96:
      return launch_fa_wgmma<128, 96>(q, k, v, o, lse, B, S, H, KVH, D,
          softcap, window, stream);
    case 112:
      return launch_fa_wgmma<128, 112>(q, k, v, o, lse, B, S, H, KVH, D,
          softcap, window, stream);
    case 128:
      return launch_fa_wgmma<128, 128>(q, k, v, o, lse, B, S, H, KVH, D,
          softcap, window, stream);
    case 256:
      return launch_fa_wgmma<256, 256>(q, k, v, o, lse, B, S, H, KVH, D,
          softcap, window, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}


// ---------------------------------------------------------------------------
// K8, float32: 3xTF32 on the tensor cores, a producer warpgroup
// ---------------------------------------------------------------------------

// the f32 kernel's tiles: DP is the head width rounded up to the 32 floats
// (128 bytes) of one swizzle row
template <int DP>
struct FaTf32 {
  static constexpr int BQ = 64;                    // query rows of a CTA
  static constexpr int BK = DP > 128 ? 32 : 64;    // keys per tile
  static constexpr int SLOTS = DP > 128 ? 1 : 2;   // K/V ring depth
  static constexpr int Q_BYTES = BQ * DP * 4;      // Q's hi (or lo)
  static constexpr int KV_BYTES = BK * DP * 4;     // a K's or V's hi (or lo)
  static constexpr int SLOT_BYTES = 2 * KV_BYTES;  // hi, then lo
  static constexpr int THREADS = 2 * 128;  // consumer WG, producer WG
  // Q's hi and lo, the ring, 1 KB of slack to align the swizzled tiles,
  // and the barriers
  static constexpr int SMEM = 2 * Q_BYTES + SLOTS * SLOT_BYTES + 1024 + 64;
};

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero, as a .b32 whose low 13 bits are zero
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// the 3xTF32 split: x = hi + lo + a remainder below 2^-21 |x|
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// byte offset of the 16-byte chunk c (floats 4c .. 4c + 3) of row r in a
// K-major tile of `rows` rows under the 128-byte swizzle that wgmma reads:
// column blocks of 32 floats, `rows` x 128 bytes apart, and the chunk's
// place in its 128-byte row XORed with r % 8
__device__ __forceinline__ uint32_t swz128(int rows, int r, int c) {
  return static_cast<uint32_t>((c / 8) * rows * 128 + r * 128 +
                               (((c % 8) ^ (r % 8)) << 4));
}

__device__ __forceinline__ void st_shared4(uint32_t addr, uint4 x) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};" ::"r"(addr),
               "r"(x.x), "r"(x.y), "r"(x.z), "r"(x.w)
               : "memory");
}

// The producer's tiles go through registers in two steps, so a tile's
// loads are in flight while the slot it goes to is still in use: fetch (at
// most 16 float4 a thread) and put (split into hi and lo, stored
// swizzled).

// Q and K: rows 0 .. ROWS - 1 of src (row stride ld floats, D columns),
// rows from n_valid on zeros, 16 of a thread's float4s from its u0-th on;
// put stores them times mul, K-major as they are.
template <int ROWS, int D>
struct RowItems {
  static constexpr int C4 = D / 4, NT = ROWS * C4 / 128;  // items a thread
  static constexpr int PASS = NT < 16 ? NT : 16;          // a fetch's
  static_assert(ROWS * C4 % 128 == 0 && NT % PASS == 0, "tile shape");
};

template <int ROWS, int D>
__device__ __forceinline__ void fetch_rows(float4 (&x)[16], const float* src,
                                           long long ld, int n_valid,
                                           int tid, int u0 = 0) {
  using I = RowItems<ROWS, D>;
#pragma unroll
  for (int u = 0; u < I::PASS; ++u) {
    const int i = tid + 128 * (u0 + u), r = i / I::C4, c = i % I::C4;
    x[u] = r < n_valid
               ? *reinterpret_cast<const float4*>(src + r * ld + 4 * c)
               : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

template <int ROWS, int D>
__device__ __forceinline__ void put_rows(const float4 (&x)[16], uint32_t dst,
                                         uint32_t lo_off, int tid,
                                         int u0 = 0, float mul = 1.f) {
  using I = RowItems<ROWS, D>;
#pragma unroll
  for (int u = 0; u < I::PASS; ++u) {
    const int i = tid + 128 * (u0 + u), r = i / I::C4, c = i % I::C4;
    uint4 hi, lo;
    split_tf32(x[u].x * mul, hi.x, lo.x);
    split_tf32(x[u].y * mul, hi.y, lo.y);
    split_tf32(x[u].z * mul, hi.z, lo.z);
    split_tf32(x[u].w * mul, hi.w, lo.w);
    const uint32_t a = dst + swz128(ROWS, r, c);
    st_shared4(a, hi);
    st_shared4(a + lo_off, lo);
  }
}

// V, transposed: rows 0 .. BK - 1 of src (keys, row stride ld, D columns)
// become V^T, DP rows of BK keys, K-major (keys contiguous) as .tf32
// wgmma takes its B operand; keys from n_valid on are zeros.  The keys of
// each group of 8 are stored in the order 0 2 4 6 1 3 5 7: the .tf32 A
// fragment of a k8 step holds positions t and t + 4 (t = lane % 4), where
// P's accumulator layout holds keys 2t and 2t + 1, so position t must hold
// key 2t and t + 4 key 2t + 1.  An item of a thread is the 4 keys of one
// 16-byte chunk kg x 4 columns (float4 c), stored as one chunk a column.
// A warp takes 4 chunks x 8 float4s: each of its loads reads 4 keys' 128
// contiguous bytes, and the 8 lanes of a store phase (4 chunks x 2
// float4s, so rows d % 8 = e and e + 4) write 8 distinct chunks.
template <int BK, int D>
struct VItems {
  static constexpr int KG = BK / 4, C4 = D / 4;
  static constexpr int NKB = KG / 4, NCB = (C4 + 7) / 8;  // warp blocks
  static constexpr int NT = NKB * NCB * 32 / 128;         // items a thread
  static_assert(KG % 4 == 0 && NKB * NCB % 4 == 0 && NT <= 4, "tile shape");
  // item u of thread tid: its chunk kg and float4 c (c >= C4: none)
  __device__ static __forceinline__ void at(int tid, int u, int& kg,
                                            int& c) {
    const int blk = tid / 32 + 4 * u, l = tid % 32;
    kg = 4 * (blk % NKB) + (l / 2) % 4;
    c = 8 * (blk / NKB) + l % 2 + 2 * (l / 8);
  }
};

template <int BK, int D>
__device__ __forceinline__ void fetch_v(float4 (&x)[16], const float* src,
                                        long long ld, int n_valid, int tid) {
  using I = VItems<BK, D>;
#pragma unroll
  for (int u = 0; u < I::NT; ++u) {
    int kg, c;
    I::at(tid, u, kg, c);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = 8 * (kg / 2) + 2 * j + kg % 2;
      x[4 * u + j] = c < I::C4 && r < n_valid
                         ? *reinterpret_cast<const float4*>(src + r * ld +
                                                            4 * c)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

template <int BK, int D, int DP>
__device__ __forceinline__ void put_v(const float4 (&x)[16], uint32_t dst,
                                      uint32_t lo_off, int tid) {
  using I = VItems<BK, D>;
#pragma unroll
  for (int u = 0; u < I::NT; ++u) {
    int kg, c;
    I::at(tid, u, kg, c);
    if (c >= I::C4) continue;
    const float4* y = x + 4 * u;
    const float col[4][4] = {{y[0].x, y[1].x, y[2].x, y[3].x},
                             {y[0].y, y[1].y, y[2].y, y[3].y},
                             {y[0].z, y[1].z, y[2].z, y[3].z},
                             {y[0].w, y[1].w, y[2].w, y[3].w}};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint4 hi, lo;
      split_tf32(col[e][0], hi.x, lo.x);
      split_tf32(col[e][1], hi.y, lo.y);
      split_tf32(col[e][2], hi.z, lo.z);
      split_tf32(col[e][3], hi.w, lo.w);
      const uint32_t a = dst + swz128(DP, 4 * c + e, kg);
      st_shared4(a, hi);
      st_shared4(a + lo_off, lo);
    }
  }
}


// d += A B for one k8 step of .tf32 operands (f32 accumulation), m64nN with
// NA = N/2 accumulator registers.  WGMMA_TF32_SS reads A and B through
// descriptors (both K-major: .tf32 takes no transpose), WGMMA_TF32_RS takes
// A from registers (4 tf32 a thread) and accumulates unless scale_d is 0.
#define WGMMA_TF32_SS(N, NA, IA, IB, IS)                                  \
  asm volatile("{\n.reg .pred p;\n"                                      \
               "setp.ne.b32 p, %" #IS ", 0;\n"                           \
               "wgmma.mma_async.sync.aligned.m64n" #N                    \
               "k8.f32.tf32.tf32 {" WG_L##NA "}, %" #IA ", %" #IB        \
               ", p, 1, 1;\n}\n"                                         \
               : WG_D##NA(d)                                              \
               : "l"(a), "l"(b), "r"(scale_d))
#define WGMMA_TF32_RS(N, NA, I0, I1, I2, I3, IB, IS)                      \
  asm volatile("{\n.reg .pred p;\n"                                      \
               "setp.ne.b32 p, %" #IS ", 0;\n"                           \
               "wgmma.mma_async.sync.aligned.m64n" #N                    \
               "k8.f32.tf32.tf32 {" WG_L##NA "}, {%" #I0 ", %" #I1       \
               ", %" #I2 ", %" #I3 "}, %" #IB ", p, 1, 1;\n}\n"          \
               : WG_D##NA(d)                                              \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),     \
                 "r"(scale_d))

template <int N>
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[N / 2], uint64_t a,
                                              uint64_t b, int scale_d) {
  if constexpr (N == 32) {
    WGMMA_TF32_SS(32, 16, 16, 17, 18);
  } else {
    static_assert(N == 64, "S tiles are 32 or 64 keys");
    WGMMA_TF32_SS(64, 32, 32, 33, 34);
  }
}

template <int N>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[N / 2],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int scale_d = 1) {
  if constexpr (N == 8) {
    WGMMA_TF32_RS(8, 4, 4, 5, 6, 7, 8, 9);
  } else if constexpr (N == 16) {
    WGMMA_TF32_RS(16, 8, 8, 9, 10, 11, 12, 13);
  } else if constexpr (N == 32) {
    WGMMA_TF32_RS(32, 16, 16, 17, 18, 19, 20, 21);
  } else if constexpr (N == 48) {
    WGMMA_TF32_RS(48, 24, 24, 25, 26, 27, 28, 29);
  } else if constexpr (N == 56) {
    WGMMA_TF32_RS(56, 28, 28, 29, 30, 31, 32, 33);
  } else if constexpr (N == 64) {
    WGMMA_TF32_RS(64, 32, 32, 33, 34, 35, 36, 37);
  } else if constexpr (N == 96) {
    WGMMA_TF32_RS(96, 48, 48, 49, 50, 51, 52, 53);
  } else if constexpr (N == 112) {
    WGMMA_TF32_RS(112, 56, 56, 57, 58, 59, 60, 61);
  } else if constexpr (N == 128) {
    WGMMA_TF32_RS(128, 64, 64, 65, 66, 67, 68, 69);
  } else {
    static_assert(N == 256, "widths 8 to 256");
    WGMMA_TF32_RS(256, 128, 128, 129, 130, 131, 132, 133);
  }
}

// The online softmax of one f32 tile: sc holds the scores of rows r0
// (even i / 2) and r0 + 8 (odd i / 2) at keys k0 + 8 (i / 4) + c2 + i % 2,
// already scaled (q was scaled before the product).  With a softcap,
// s = softcap tanh(s / softcap) (tanhf: the f32 bar leaves no room for an
// approximate tanh); masked scores -1e30, on the tiles `edge` flags, as in
// softmax_tile (with kWindow the window's edge too); exp(s - m) =
// 2^(s log2 e - m log2 e) (one FFMA and one MUFU.EX2), with kWindow 0 for
// a row masked so far.  On return sc holds the unrounded p, ls the row
// sums of this thread's p, alpha = exp(m_old - m_new).
template <int BK, bool kWindow>
__device__ __forceinline__ void softmax_f32(float (&sc)[BK / 2],
                                            float (&m)[2], float (&alpha)[2],
                                            float (&ls)[2], int k0, int r0,
                                            int c2, bool edge, int window,
                                            float softcap) {
  if (softcap > 0.f) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i)
      sc[i] = softcap * tanhf(sc[i] / softcap);
  }
  if (edge) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int key = k0 + 8 * (i / 4) + c2 + (i % 2);
      const int row = r0 + 8 * ((i / 2) % 2);
      if (key > row || (kWindow && key + window <= row)) sc[i] = -1e30f;
    }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i)
    mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
  float mc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = ex2_approx((m[r] - mx[r]) * FA_LOG2E);
    m[r] = mx[r];
    mc[r] = kWindow && mx[r] == -1e30f ? FA_MINUS_INF  // as above
                                       : -mx[r] * FA_LOG2E;
    ls[r] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const int r = (i / 2) % 2;
    sc[i] = ex2_approx(fmaf(sc[i], FA_LOG2E, mc[r]));
    ls[r] += sc[i];
  }
}

// One CTA per query tile of 64 rows of one (b, h), the longest rows first
// (a 1-D grid of B * H * ceil(S / 64)): a tile's key tiles run from the
// window's lower edge (0 without a window) to the causal frontier, a count
// that does not fall from one query tile to the next but at the ragged
// last one (under a window it grows until the window is full and then
// stays), so the last query tiles first are still the longest first.
// Warpgroup 1 produces: it loads Q once and then the tile's K and V key
// tiles in turn through a ring of SLOTS slots, each tile split into TF32
// hi and lo in its pass (V transposed), and signals a full barrier;
// warpgroup 0 consumes: S = Q K^T over D / 8 k8 steps of three products
// each, the softmax, P split in registers (the S accumulator's registers
// 4 kt .. 4 kt + 3 are the A fragment of the k8 step kt of P V, taken in
// the order 0 2 1 3 that put_v's key order matches), then O += P V,
// releasing each slot on its empty barrier as soon as its products are
// done.
template <int DP, int D, bool kWindow>
__global__ void __launch_bounds__(FaTf32<DP>::THREADS, 1)
    flash_attention_fwd_kernel(const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v,
                               float* __restrict__ o,
                               float* __restrict__ lse, int B, int S, int H,
                               int KVH, float scale, float softcap,
                               int window) {
  using T = FaTf32<DP>;
  constexpr int BQ = T::BQ, BK = T::BK, NS = T::SLOTS;
  constexpr int NC = D > 128 ? 128 : D;  // columns of one P V product
  extern __shared__ uint8_t fa_raw[];
  const uint32_t sq = (smem_u32(fa_raw) + 1023) & ~1023u;  // Q hi, Q lo
  const uint32_t ring = sq + 2 * T::Q_BYTES;
  const uint32_t q_full = ring + NS * T::SLOT_BYTES;  // 8-byte barriers
  const uint32_t full = q_full + 8;                   // [NS]
  const uint32_t empty = full + 8 * NS;               // [NS]

  const int nq = (S + BQ - 1) / BQ;
  const int bh = blockIdx.x % (B * H);
  const int qt = nq - 1 - static_cast<int>(blockIdx.x / (B * H));
  const int b = bh / H, h = bh % H, kvh = h / (H / KVH);
  const int q0 = qt * BQ;
  // the window's lower edge
  const int lo = kWindow ? max(0, q0 - window + 1) / BK : 0;
  // key tiles lo .. the causal frontier
  const int n_tiles = (min(q0 + BQ, S) + BK - 1) / BK - lo;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 128);
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + 8 * s, 128);
      mbar_init(empty + 8 * s, 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int tid = threadIdx.x % 128;

  if (threadIdx.x >= 128) {
    // producer: every thread stores its share of a tile, makes its writes
    // visible to the tensor cores (the async proxy) and arrives.  The first
    // K tile's loads are issued first, so they land while Q is split.
    const long long q_ld = static_cast<long long>(H) * D;
    const long long kv_ld = static_cast<long long>(KVH) * D;
    const long long kv0 = static_cast<long long>(b) * S * kv_ld +
                          static_cast<long long>(kvh) * D +
                          static_cast<long long>(lo) * BK * kv_ld;
    const int S_kv = S - lo * BK;  // keys from the first tile on
    float4 kx[16], vx[16];
    fetch_rows<BK, D>(kx, k + kv0, kv_ld, S_kv, tid);
    // Q, times 1/sqrt(D) in f32, 16 float4s a thread at a time (32 at D
    // 256); a K tile is 16 at most
    static_assert(RowItems<BK, D>::NT <= 16, "K tile");
    const float* qsrc = q + (static_cast<long long>(b) * S + q0) * q_ld +
                        static_cast<long long>(h) * D;
    using QI = RowItems<BQ, D>;
#pragma unroll 1
    for (int u0 = 0; u0 < QI::NT; u0 += QI::PASS) {
      fetch_rows<BQ, D>(vx, qsrc, q_ld, S - q0, tid, u0);
      put_rows<BQ, D>(vx, sq, T::Q_BYTES, tid, u0, scale);
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    mbar_arrive(q_full);
    // item g of the ring: K_{lo+g/2} (even g) or V_{lo+g/2}; its slot is
    // free once the consumer released the item NS before it
    auto slot_of = [&](int g) {
      const int s = g % NS;
      if (g >= NS) mbar_wait(empty + 8 * s, ((g / NS) - 1) & 1);
      return ring + s * T::SLOT_BYTES;
    };
    auto done = [&](int g) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      mbar_arrive(full + 8 * (g % NS));
    };
    // each tile's loads are issued one item ahead of its stores (three
    // buffers, two items ahead, spill at D 112 and run slower)
    for (int t = 0; t < n_tiles; ++t) {
      const int k0 = t * BK;  // from the first tile's key
      fetch_v<BK, D>(vx, v + kv0 + k0 * kv_ld, kv_ld, S_kv - k0, tid);
      put_rows<BK, D>(kx, slot_of(2 * t), T::KV_BYTES, tid);
      done(2 * t);
      if (t + 1 < n_tiles)
        fetch_rows<BK, D>(kx, k + kv0 + (k0 + BK) * kv_ld, kv_ld,
                          S_kv - k0 - BK, tid);
      put_v<BK, D, DP>(vx, slot_of(2 * t + 1), T::KV_BYTES, tid);
      done(2 * t + 1);
    }
    return;
  }

  // consumer: this thread holds rows r0 and r0 + 8 of the tile, at columns
  // 8 j + c2 + {0, 1} of each n8 block j of an accumulator (wgmma's m64nN
  // f32 layout)
  const int c2 = 2 * (tid % 4);
  const int r0 = q0 + 16 * (tid / 32) + (tid % 32) / 4;
  float acc[D / 2], m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};
  uint32_t ph[BK / 8][4], pl[BK / 8][4];  // P's A fragments, hi and lo
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  // S = Q K^T of key tile t (ring item 2t): per k8 step (32 bytes of a
  // 128-byte row; a new column block every 4 steps) Q_hi K_hi + Q_hi K_lo
  // + Q_lo K_hi
  auto issue_s = [&](float (&sc)[BK / 2], int t) {
    const int g = 2 * t;
    const uint32_t kh = ring + (g % NS) * T::SLOT_BYTES;
    const uint32_t kl = kh + T::KV_BYTES;
    mbar_wait(full + 8 * (g % NS), (g / NS) & 1);
    wgmma_fence();
    // the small cross terms first, into a small sum, then the hi products:
    // the tensor cores truncate each sum they add to, so the big terms
    // are added last and the fewest times
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const uint32_t ao = (kk / 4) * BQ * 128 + (kk % 4) * 32;
      const uint32_t bo = (kk / 4) * BK * 128 + (kk % 4) * 32;
      wgmma_tf32_ss<BK>(sc, wgmma_desc(sq + ao, 16, 1024),
                        wgmma_desc(kl + bo, 16, 1024), kk > 0);
      wgmma_tf32_ss<BK>(sc, wgmma_desc(sq + T::Q_BYTES + ao, 16, 1024),
                        wgmma_desc(kh + bo, 16, 1024), 1);
    }
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const uint32_t ao = (kk / 4) * BQ * 128 + (kk % 4) * 32;
      const uint32_t bo = (kk / 4) * BK * 128 + (kk % 4) * 32;
      wgmma_tf32_ss<BK>(sc, wgmma_desc(sq + ao, 16, 1024),
                        wgmma_desc(kh + bo, 16, 1024), 1);
    }
    wgmma_commit();
  };
  // P V of key tile t (ring item 2t + 1), columns NC c .. NC c + NC - 1,
  // into a fresh sum `part`: per k8 step of 8 keys, P_hi V_lo + P_lo V_hi
  // first, then P_hi V_hi (as in S); V^T read K-major (D rows of BK keys,
  // 8-row groups 1024 bytes apart)
  auto issue_pv = [&](int t, int c, float (&part)[NC / 2]) {
    const int g = 2 * t + 1;
    const uint32_t vh = ring + (g % NS) * T::SLOT_BYTES + c * NC * 128;
    const uint32_t vl = vh + T::KV_BYTES;
    mbar_wait(full + 8 * (g % NS), (g / NS) & 1);
#pragma unroll
    for (int i = 0; i < NC / 2; ++i) part[i] = 0.f;
    wgmma_pin(part);
    wgmma_pin(ph);
    wgmma_pin(pl);
    wgmma_fence();
#pragma unroll
    for (int kt = 0; kt < BK / 8; ++kt) {
      const uint32_t bo = (kt / 4) * DP * 128 + (kt % 4) * 32;
      wgmma_tf32_rs<NC>(part, ph[kt], wgmma_desc(vl + bo, 16, 1024));
      wgmma_tf32_rs<NC>(part, pl[kt], wgmma_desc(vh + bo, 16, 1024));
    }
#pragma unroll
    for (int kt = 0; kt < BK / 8; ++kt) {
      const uint32_t bo = (kt / 4) * DP * 128 + (kt % 4) * 32;
      wgmma_tf32_rs<NC>(part, ph[kt], wgmma_desc(vh + bo, 16, 1024));
    }
    wgmma_commit();
  };
  auto release = [&](int g) { mbar_arrive(empty + 8 * (g % NS)); };
  auto softmax = [&](float (&sc)[BK / 2], int t, float (&alpha)[2],
                     float (&ls)[2]) {
    const int k0 = (lo + t) * BK;
    softmax_f32<BK, kWindow>(
        sc, m, alpha, ls, k0, r0, c2,
        k0 + BK - 1 > q0 || (kWindow && k0 + window <= q0 + BQ - 1), window,
        softcap);
  };
  // P into the A fragments of P V, and the rescaled l and O.  a0 .. a3 of
  // step kt: (row r0, key 2t), (r0 + 8, 2t), (r0, 2t + 1), (r0 + 8,
  // 2t + 1) of the tile's keys 8 kt .. 8 kt + 7
  auto take_p = [&](const float (&sc)[BK / 2], const float (&alpha)[2],
                    const float (&ls)[2]) {
#pragma unroll
    for (int kt = 0; kt < BK / 8; ++kt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split_tf32(sc[4 * kt + (e % 2) * 2 + e / 2], ph[kt][e], pl[kt][e]);
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + ls[r];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i / 2) % 2];
  };

  mbar_wait(q_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    float sc[BK / 2], alpha[2], ls[2];
    issue_s(sc, t);
    wgmma_wait<0>();
    wgmma_pin(sc);
    release(2 * t);
    softmax(sc, t, alpha, ls);
    take_p(sc, alpha, ls);
    // O = alpha O + P V: each tile's P V summed apart on the tensor cores,
    // then added to O in f32 registers, rounded to nearest
#pragma unroll
    for (int c = 0; c < D / NC; ++c) {
      float part[NC / 2];
      issue_pv(t, c, part);
      wgmma_wait<0>();
      wgmma_pin(part);
#pragma unroll
      for (int i = 0; i < NC / 2; ++i) acc[NC / 2 * c + i] += part[i];
    }
    release(2 * t + 1);
  }
  // O / max(l, 1e-20): the 4 threads of a quad hold a row's columns
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = r0 + 8 * r;
    if (row >= S) continue;
    // the row's log-sum-exp for the backward (training only)
    if (lse != nullptr && tid % 4 == 0)
      lse[(static_cast<long long>(b) * H + h) * S + row] = m[r] + logf(l[r]);
    const float inv = 1.f / fmaxf(l[r], 1e-20f);
    float* out = o + (static_cast<long long>(b) * S + row) * H * D +
                 static_cast<long long>(h) * D + c2;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(out + 8 * j) =
          make_float2(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
  }
}

template <int DP, int D>
static int launch_fa_tf32(const void* q, const void* k, const void* v,
                          void* o, float* lse, int B, int S, int H, int KVH,
                          float softcap, int window, cudaStream_t stream) {
  using T = FaTf32<DP>;
  // a window of S keys or more is no window: the causal instance
  auto kernel = window > 0 && window < S
                    ? flash_attention_fwd_kernel<DP, D, true>
                    : flash_attention_fwd_kernel<DP, D, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks =
      static_cast<long long>(B) * H * ((S + T::BQ - 1) / T::BQ);
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return 0;
  kernel<<<static_cast<unsigned>(blocks), T::THREADS, T::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, B, S, H,
      KVH, 1.0f / sqrtf(static_cast<float>(D)), softcap, window);
  return static_cast<int>(cudaGetLastError());
}

// float32 only: bf16 runs flash_attention_wgmma_kernel
static int dispatch_fa_f32(const void* q, const void* k, const void* v,
                           void* o, float* lse, int B, int S, int H, int KVH,
                           int D, float softcap, int window,
                           cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch_fa_tf32<32, 16>(q, k, v, o, lse, B, S, H, KVH, softcap,
          window, stream);
    case 32:
      return launch_fa_tf32<32, 32>(q, k, v, o, lse, B, S, H, KVH, softcap,
          window, stream);
    case 64:
      return launch_fa_tf32<64, 64>(q, k, v, o, lse, B, S, H, KVH, softcap,
          window, stream);
    case 96:
      return launch_fa_tf32<96, 96>(q, k, v, o, lse, B, S, H, KVH, softcap,
          window, stream);
    case 112:
      return launch_fa_tf32<128, 112>(q, k, v, o, lse, B, S, H, KVH, softcap,
          window, stream);
    case 128:
      return launch_fa_tf32<128, 128>(q, k, v, o, lse, B, S, H, KVH, softcap,
          window, stream);
    case 256:
      return launch_fa_tf32<256, 256>(q, k, v, o, lse, B, S, H, KVH, softcap,
          window, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// K9
// ---------------------------------------------------------------------------

#define RN_THREADS 256   // lanes of the sum of squares (cta_sum)
#define RN_SEGMENT 1024  // elements the lanes take at once, 4 each

// 16 and 8 bytes of device memory as 32-bit words, in registers: K9's
// inputs are read-only while it runs (the non-coherent path), its outputs
// written once
__device__ __forceinline__ uint4 ld16(const void* p) {
  uint4 v;
  asm("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}
// a 16-byte piece of a row read once (a prefill's rows): it leaves L1
// alone, and is issued in program order (asm volatile), so a thread's
// loads of its row are all in flight before the first is used
__device__ __forceinline__ uint4 ld16_once(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}
// a store of data written once (a prefill's rows): evicted first
__device__ __forceinline__ void st16_once(void* p, uint32_t a, uint32_t b,
                                          uint32_t c, uint32_t d) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};" ::"l"(p),
               "r"(a), "r"(b), "r"(c), "r"(d)
               : "memory");
}
__device__ __forceinline__ uint2 ld8(const void* p) {
  uint2 v;
  asm("ld.global.nc.v2.u32 {%0, %1}, [%2];" : "=r"(v.x), "=r"(v.y) : "l"(p));
  return v;
}
__device__ __forceinline__ void st16(void* p, uint32_t a, uint32_t b,
                                     uint32_t c, uint32_t d) {
  asm volatile("st.global.v4.u32 [%0], {%1, %2, %3, %4};" ::"l"(p), "r"(a),
               "r"(b), "r"(c), "r"(d)
               : "memory");
}
__device__ __forceinline__ void st8(void* p, uint32_t a, uint32_t b) {
  asm volatile("st.global.v2.u32 [%0], {%1, %2};" ::"l"(p), "r"(a), "r"(b)
               : "memory");
}

// a 16-byte piece as f32: 4 f32 or 8 bf16
template <typename T>
__device__ __forceinline__ void unpack16(uint4 q, float* v) {
  if constexpr (sizeof(T) == 4) {
    v[0] = __uint_as_float(q.x);
    v[1] = __uint_as_float(q.y);
    v[2] = __uint_as_float(q.z);
    v[3] = __uint_as_float(q.w);
  } else {
    v[0] = bf16_lo(q.x);
    v[1] = bf16_hi(q.x);
    v[2] = bf16_lo(q.y);
    v[3] = bf16_hi(q.y);
    v[4] = bf16_lo(q.z);
    v[5] = bf16_hi(q.z);
    v[6] = bf16_lo(q.w);
    v[7] = bf16_hi(q.w);
  }
}

// n consecutive elements (n = 4: 16 bytes of f32, 8 of bf16; n = 8: 32 of
// f32, 16 of bf16) read into f32 registers in 16-byte pieces where they fill
// them, and written back from them (kOnce: with st16_once)
template <int N>
__device__ __forceinline__ void load_n(const float* p, float* v) {
#pragma unroll
  for (int c = 0; c < N / 4; ++c) {
    const uint4 q = ld16(p + 4 * c);
    v[4 * c] = __uint_as_float(q.x);
    v[4 * c + 1] = __uint_as_float(q.y);
    v[4 * c + 2] = __uint_as_float(q.z);
    v[4 * c + 3] = __uint_as_float(q.w);
  }
}
template <int N>
__device__ __forceinline__ void load_n(const bf16* p, float* v) {
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int c = 0; c < N / 8; ++c) unpack16<bf16>(ld16(p + 8 * c), v + 8 * c);
  } else {
    static_assert(N == 4, "four or a multiple of eight bf16");
    const uint2 q = ld8(p);
    v[0] = bf16_lo(q.x);
    v[1] = bf16_hi(q.x);
    v[2] = bf16_lo(q.y);
    v[3] = bf16_hi(q.y);
  }
}
template <int N, bool kOnce = false>
__device__ __forceinline__ void store_n(float* p, const float* v) {
#pragma unroll
  for (int c = 0; c < N / 4; ++c) {
    const float* u = v + 4 * c;
    if (kOnce)
      st16_once(p + 4 * c, __float_as_uint(u[0]), __float_as_uint(u[1]),
                __float_as_uint(u[2]), __float_as_uint(u[3]));
    else
      st16(p + 4 * c, __float_as_uint(u[0]), __float_as_uint(u[1]),
           __float_as_uint(u[2]), __float_as_uint(u[3]));
  }
}
// two floats rounded to bf16, a in the low half
__device__ __forceinline__ uint32_t bf16_pair(float a, float b) {
  return f32_to_bf16_bits(a) | (f32_to_bf16_bits(b) << 16);
}
template <int N, bool kOnce = false>
__device__ __forceinline__ void store_n(bf16* p, const float* v) {
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int c = 0; c < N / 8; ++c) {
      const float* u = v + 8 * c;
      if (kOnce)
        st16_once(p + 8 * c, bf16_pair(u[0], u[1]), bf16_pair(u[2], u[3]),
                  bf16_pair(u[4], u[5]), bf16_pair(u[6], u[7]));
      else
        st16(p + 8 * c, bf16_pair(u[0], u[1]), bf16_pair(u[2], u[3]),
             bf16_pair(u[4], u[5]), bf16_pair(u[6], u[7]));
    }
  } else {
    static_assert(N == 4, "four or a multiple of eight bf16");
    st8(p, bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3]));
  }
}

// s of n elements at i of the row: x, or x + r in f32 (the residual
// variant, which also writes it rounded to x's dtype as the new residual)
template <int N, typename T, bool kResidual>
__device__ __forceinline__ void row_piece(const T* __restrict__ x,
                                          const T* __restrict__ r,
                                          T* __restrict__ ro, long long at,
                                          float* s) {
  load_n<N>(x + at, s);
  if (kResidual) {
    float b[N];
    load_n<N>(r + at, b);
#pragma unroll
    for (int e = 0; e < N; ++e) s[e] += b[e];
    store_n<N>(ro + at, s);
  }
}

// The CTA's sum of squares, in the order of RN_THREADS lanes: lane t sums
// the squares of the 4 elements at 1024 c + 4 t, c = 0, 1, ... in turn,
// each 32 lanes add theirs by a shuffle tree (xor 16, 8, 4, 2, 1) and one
// shared slot a warp of them, and the 8 slots are added in order.  Every
// instance sums in that one order, so each gives the same bits.  A thread
// holds kH lanes (kH t + h in a[h]): the lane offsets 16 .. kH cross
// threads (at offset off / kH), and offset 1 of kH = 2 adds a thread's
// two.
template <int kH>
__device__ __forceinline__ float cta_sum(float (&a)[kH]) {
  __shared__ float partial[RN_THREADS / 32];
#pragma unroll
  for (int off = 16; off >= kH; off >>= 1) {
#pragma unroll
    for (int h = 0; h < kH; ++h)
      a[h] += __shfl_xor_sync(0xffffffffu, a[h], off / kH);
  }
  if constexpr (kH == 2) a[0] += a[1];
  if (threadIdx.x % (32 / kH) == 0) partial[threadIdx.x / (32 / kH)] = a[0];
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int q = 0; q < RN_THREADS / 32; ++q) total += partial[q];
  return total;
}

// One CTA per row.  kD > 0: the instance of width kD, the row held in
// registers: a thread holds the 16-byte pieces (E elements) at 1024 c + E t
// of the row, the lanes E t / 4 .. of cta_sum; with kHoldW the weight's
// pieces too, loaded beside the row, each piece used as it comes; else
// (a prefill's rows) every load of the row is issued before the first is
// used, with the read-once hints (ld16_once, st16_once), and the weight is
// loaded after the reduction (with the loads and the arithmetic
// interleaved, such a call on an H100 ran further from a copy of its
// bytes; issued first in the decode instance, ptxas spilled).  kD == 0:
// the general instance, lane t a thread, pieces of 4 elements, the row read
// again for the scale.
template <typename T, typename W, bool kResidual, int kD, bool kHoldW>
__global__ void __launch_bounds__(kD > 0 ? RN_SEGMENT * sizeof(T) / 16
                                         : RN_THREADS)
    rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ r,
                   const W* __restrict__ w, T* __restrict__ o,
                   T* __restrict__ ro, int d, float eps) {
  const long long base = static_cast<long long>(blockIdx.x) * d;
  if constexpr (kD > 0) {
    constexpr int E = 16 / sizeof(T);  // elements of a piece
    constexpr int H = E / 4;           // lanes of the sum a thread holds
    constexpr int A = (kD + RN_SEGMENT - 1) / RN_SEGMENT;  // pieces, at most
    float s[A][E], g[A][E], a[H] = {};
    if constexpr (kHoldW) {
#pragma unroll
      for (int c = 0; c < A; ++c) {
        const int i = c * RN_SEGMENT + E * threadIdx.x;
        if (i < kD) {
          row_piece<E, T, kResidual>(x, r, ro, base + i, s[c]);
          load_n<E>(w + i, g[c]);
#pragma unroll
          for (int e = 0; e < E; ++e) a[e / 4] += s[c][e] * s[c][e];
        }
      }
    } else {
      uint4 qx[A], qr[A];
#pragma unroll
      for (int c = 0; c < A; ++c) {  // every load of the row issued first
        const int i = c * RN_SEGMENT + E * threadIdx.x;
        if (i < kD) {
          qx[c] = ld16_once(x + base + i);
          if (kResidual) qr[c] = ld16_once(r + base + i);
        }
      }
#pragma unroll
      for (int c = 0; c < A; ++c) {
        const int i = c * RN_SEGMENT + E * threadIdx.x;
        if (i < kD) {
          unpack16<T>(qx[c], s[c]);
          if (kResidual) {
            float b[E];
            unpack16<T>(qr[c], b);
#pragma unroll
            for (int e = 0; e < E; ++e) s[c][e] += b[e];
            store_n<E, true>(ro + base + i, s[c]);
          }
#pragma unroll
          for (int e = 0; e < E; ++e) a[e / 4] += s[c][e] * s[c][e];
        }
      }
    }
    const float inv =
        1.0f / sqrtf(cta_sum<H>(a) / static_cast<float>(kD) + eps);
#pragma unroll
    for (int c = 0; c < A; ++c) {
      const int i = c * RN_SEGMENT + E * threadIdx.x;
      if (i < kD) {
        if (!kHoldW) load_n<E>(w + i, g[c]);
        float out[E];
#pragma unroll
        for (int e = 0; e < E; ++e) out[e] = s[c][e] * inv * (1.0f + g[c][e]);
        store_n<E, !kHoldW>(o + base + i, out);
      }
    }
  } else {
    // the loops not unrolled: unrolled, ptxas spilled a word of the
    // float32 residual instance
    float ss = 0.f;
#pragma unroll 1
    for (int i = 4 * threadIdx.x; i < d; i += RN_SEGMENT) {
      float s[4];
      row_piece<4, T, kResidual>(x, r, ro, base + i, s);
#pragma unroll
      for (int e = 0; e < 4; ++e) ss += s[e] * s[e];
    }
    float a[1] = {ss};
    const float inv =
        1.0f / sqrtf(cta_sum<1>(a) / static_cast<float>(d) + eps);
#pragma unroll 1
    for (int i = 4 * threadIdx.x; i < d; i += RN_SEGMENT) {
      float s[4], g[4], out[4];
      load_n<4>(x + base + i, s);
      if (kResidual) {
        float b[4];
        load_n<4>(r + base + i, b);
#pragma unroll
        for (int e = 0; e < 4; ++e) s[e] += b[e];
      }
      load_n<4>(w + i, g);
#pragma unroll
      for (int e = 0; e < 4; ++e) out[e] = s[e] * inv * (1.0f + g[e]);
      store_n<4>(o + base + i, out);
    }
  }
}

template <typename T, typename W, bool kResidual, int kD, bool kHoldW = false>
static int launch_rn(const void* x, const void* r, const void* w, void* o,
                     void* ro, long long rows, int d, float eps,
                     cudaStream_t stream) {
  constexpr int threads = kD > 0 ? RN_SEGMENT * sizeof(T) / 16 : RN_THREADS;
  rmsnorm_kernel<T, W, kResidual, kD, kHoldW>
      <<<static_cast<unsigned>(rows), threads, 0, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(r),
          static_cast<const W*>(w), static_cast<T*>(o), static_cast<T*>(ro),
          d, eps);
  return static_cast<int>(cudaGetLastError());
}

// the instance of d: the served widths hold their rows in registers, and
// at a decode step's few rows (up to RN_HOLD_ROWS) the weight too: there
// the call is one round trip to memory, and the weight's, issued with the
// row's, costs it nothing, where loaded after the reduction it adds one; a
// prefill's rows leave it to L1 and L2 and keep the registers for more
// rows in flight (both measured faster so on an H100)
#define RN_HOLD_ROWS 256
template <typename T, typename W, bool kResidual, int kD>
static int launch_rn_rows(const void* x, const void* r, const void* w,
                          void* o, void* ro, long long rows, int d, float eps,
                          cudaStream_t stream) {
  return rows <= RN_HOLD_ROWS
             ? launch_rn<T, W, kResidual, kD, true>(x, r, w, o, ro, rows, d,
                                                    eps, stream)
             : launch_rn<T, W, kResidual, kD, false>(x, r, w, o, ro, rows, d,
                                                     eps, stream);
}

template <typename T, typename W, bool kResidual>
static int launch_rn_d(const void* x, const void* r, const void* w, void* o,
                       void* ro, long long rows, int d, float eps,
                       cudaStream_t stream) {
  switch (d) {
    case 3584:
      return launch_rn_rows<T, W, kResidual, 3584>(x, r, w, o, ro, rows, d,
                                                   eps, stream);
    case 4096:
      return launch_rn_rows<T, W, kResidual, 4096>(x, r, w, o, ro, rows, d,
                                                   eps, stream);
    case 7168:
      return launch_rn_rows<T, W, kResidual, 7168>(x, r, w, o, ro, rows, d,
                                                   eps, stream);
    default:
      return launch_rn<T, W, kResidual, 0>(x, r, w, o, ro, rows, d, eps,
                                           stream);
  }
}

template <bool kResidual>
static int dispatch_rn(const void* x, const void* r, const void* w, void* o,
                       void* ro, int dtype, int w_dtype, long long rows,
                       int d, float eps, cudaStream_t stream) {
  if (rows == 0) return 0;
  if (dtype == DT_F32 && w_dtype == DT_F32)
    return launch_rn_d<float, float, kResidual>(x, r, w, o, ro, rows, d, eps,
                                                stream);
  if (dtype == DT_F32 && w_dtype == DT_BF16)
    return launch_rn_d<float, bf16, kResidual>(x, r, w, o, ro, rows, d, eps,
                                               stream);
  if (dtype == DT_BF16 && w_dtype == DT_F32)
    return launch_rn_d<bf16, float, kResidual>(x, r, w, o, ro, rows, d, eps,
                                               stream);
  if (dtype == DT_BF16 && w_dtype == DT_BF16)
    return launch_rn_d<bf16, bf16, kResidual>(x, r, w, o, ro, rows, d, eps,
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

// K10's backward (no TPU counterpart: the reference differentiates its
// lax.scan with XLA).  With out_c the state before chunk c (out_{c+1} =
// decay_c out_c + s_c) and g_c the gradient arriving at out_c, the adjoint
// walks the chunks backwards from a_nc = 0:
//   d s_c = a_{c+1},  d decay_c = sum over (N, P) of a_{c+1} out_c,
//   a_c = g_c + decay_c a_{c+1}
// (the last chunk's d s and d decay are 0).  Bound by device memory: g
// and out read once, d s written once (3 x 234.9 MB at the training
// microbatch (32, 4, 112, 64, 64): 0.2103 ms at 3.35 TB/s).  One CTA per
// (b, h) of 256 threads holds that head's N P chains in registers, 16 a
// thread, and walks c downward; N P past 4096 runs in passes of 4096
// chains.  Each step issues the loads of chunk c - 1 (float4 where N P %
// 4 == 0 and the pointers are 16-byte aligned; N P is contiguous for each
// (c, b, h)) before it reduces chunk c, so the serial walk waits on one
// load latency a step, not two.  d decay_c is summed in float64 (each
// product exact) in one fixed order: a thread's 16, then warp shuffles,
// then the 8 warps in order by thread 0; no atomics, so the same inputs
// give the same bits, and its one rounding to float32 is the only error
// the sum adds (a pass past the first adds its float64 sum to the float32
// of the passes before).  a_c is formed as g + decay * a, rounded twice
// (--fmad=false), as the plain version does, so d s equals the plain
// version's bits.
#define SCAN_BWD_THREADS 256
#define SCAN_BWD_ITEMS 16  // chains a thread holds in a pass

template <bool kVec>
__device__ __forceinline__ long long scan_bwd_elem(int base, int i, int t) {
  return kVec ? base + ((i >> 2) * SCAN_BWD_THREADS + t) * 4 + (i & 3)
              : base + i * SCAN_BWD_THREADS + t;
}

template <bool kVec>
__device__ __forceinline__ void scan_bwd_load(const float* __restrict__ p,
                                              int base, int t, int np,
                                              float* v) {
#pragma unroll
  for (int i = 0; i < SCAN_BWD_ITEMS; i += kVec ? 4 : 1) {
    const long long e = scan_bwd_elem<kVec>(base, i, t);
    if constexpr (kVec) {
      float4 x = e < np ? *reinterpret_cast<const float4*>(p + e)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
      v[i] = x.x;
      v[i + 1] = x.y;
      v[i + 2] = x.z;
      v[i + 3] = x.w;
    } else {
      v[i] = e < np ? p[e] : 0.f;
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(SCAN_BWD_THREADS)
    ssm_state_scan_bwd_kernel(const float* __restrict__ g,
                              const float* __restrict__ out,
                              const float* __restrict__ decay,
                              float* __restrict__ ds, float* __restrict__ dd,
                              int nc, long long bh, int np) {
  __shared__ double red[2][SCAN_BWD_THREADS / 32];
  const long long head = blockIdx.x;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long chunk = bh * np;  // elements of one chunk
  constexpr int kPass = SCAN_BWD_THREADS * SCAN_BWD_ITEMS;
  int step = 0;  // parity of red: consecutive steps use other buffers
  for (int base = 0; base < np; base += kPass) {
    float a[SCAN_BWD_ITEMS], gc[SCAN_BWD_ITEMS], oc[SCAN_BWD_ITEMS];
#pragma unroll
    for (int i = 0; i < SCAN_BWD_ITEMS; ++i) a[i] = 0.f;
    long long off = (nc - 1) * chunk + head * np;
    scan_bwd_load<kVec>(g + off, base, t, np, gc);
    scan_bwd_load<kVec>(out + off, base, t, np, oc);
    float dc = decay[(nc - 1) * bh + head];
    for (int c = nc - 1; c >= 0; --c, ++step) {
      // chunk c - 1's loads, in flight while chunk c is reduced
      float gn[SCAN_BWD_ITEMS], on[SCAN_BWD_ITEMS];
      float dn = 0.f;
      if (c > 0) {  // (off - chunk: chunk c - 1 of this head)
        scan_bwd_load<kVec>(g + off - chunk, base, t, np, gn);
        scan_bwd_load<kVec>(out + off - chunk, base, t, np, on);
        dn = decay[(c - 1) * bh + head];
      }
      // d s_c = a_{c+1}, and this thread's part of d decay_c
      double s = 0.0;
#pragma unroll
      for (int i = 0; i < SCAN_BWD_ITEMS; i += kVec ? 4 : 1) {
        const long long e = scan_bwd_elem<kVec>(base, i, t);
        if (e < np) {
          if constexpr (kVec)
            *reinterpret_cast<float4*>(ds + off + e) =
                make_float4(a[i], a[i + 1], a[i + 2], a[i + 3]);
          else
            ds[off + e] = a[i];
        }
      }
#pragma unroll
      for (int i = 0; i < SCAN_BWD_ITEMS; ++i)
        s += static_cast<double>(a[i]) * static_cast<double>(oc[i]);
#pragma unroll
      for (int m = 16; m > 0; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
      if (lane == 0) red[step & 1][warp] = s;
      // a_c = g_c + decay_c a_{c+1}
#pragma unroll
      for (int i = 0; i < SCAN_BWD_ITEMS; ++i) a[i] = gc[i] + dc * a[i];
      __syncthreads();
      if (t == 0) {
        double tot = 0.0;
#pragma unroll
        for (int w = 0; w < SCAN_BWD_THREADS / 32; ++w) tot += red[step & 1][w];
        float* d = dd + c * bh + head;
        *d = base == 0 ? static_cast<float>(tot)
                       : static_cast<float>(static_cast<double>(*d) + tot);
      }
      if (c > 0) {
#pragma unroll
        for (int i = 0; i < SCAN_BWD_ITEMS; ++i) {
          gc[i] = gn[i];
          oc[i] = on[i];
        }
        dc = dn;
        off -= chunk;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K8 backward (no TPU counterpart: the reference differentiates its jnp
// attention with XLA): the rows kernel of both dtypes, then float32 on
// 3xTF32 wgmma (the bf16 kernels follow)
// ---------------------------------------------------------------------------

// four consecutive elements as f32 (16 bytes of f32, 8 of bf16), and back
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(bf16_lo(u.x), bf16_hi(u.x), bf16_lo(u.y), bf16_hi(u.y));
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(bf16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(bf16_pair(v.x, v.y),
                                            bf16_pair(v.z, v.w));
}

// lse and delta of every (b, h) in tiles of 64 rows, side by side: rows
// s of (b, h) at rows[(b H + h) 2 S64 + 128 (s / 64) + s % 64] (lse) and 64
// further (delta), S64 = S rounded up to 64, 0 past S; so a query tile's
// 512 bytes are one aligned bulk copy.  delta = rowsum(dO O) in f32, one
// warp a (b, s, h) row, s in S .. S64 - 1 written as 0 (a hidden row's
// P = 0 there, and 0 (dP - 0) stays 0)
template <typename T>
__global__ void __launch_bounds__(256)
    flash_attention_bwd_rows_kernel(const T* __restrict__ o,
                                    const T* __restrict__ dout,
                                    const float* __restrict__ lse,
                                    float* __restrict__ rows, int S, int S64,
                                    int H, int D, long long n) {
  const long long row = static_cast<long long>(blockIdx.x) * 8 +
                        threadIdx.x / 32;  // (b S64 + s) H + h
  const int lane = threadIdx.x % 32;
  if (row >= n) return;
  const long long bs = row / H;
  const int h = static_cast<int>(row % H);
  const long long b = bs / S64;
  const int s = static_cast<int>(bs % S64);
  float acc = 0.f, l = 0.f;
  if (s < S) {
    const long long at = ((b * S + s) * H + h) * D;
    for (int c = 4 * lane; c < D; c += 128) {
      const float4 a = load4(o + at + c), g = load4(dout + at + c);
      acc = fmaf(a.x, g.x, acc);
      acc = fmaf(a.y, g.y, acc);
      acc = fmaf(a.z, g.z, acc);
      acc = fmaf(a.w, g.w, acc);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    l = lse[(b * H + h) * S + s];
  }
  if (lane == 0) {
    float* t = rows + (b * H + h) * 2 * S64 + 128 * (s / 64) + s % 64;
    t[0] = l;
    t[64] = acc;
  }
}

// register budgets: the producer warpgroup (one thread issuing TMA) gives
// what the two consumer warpgroups take, within the launch's 168 x 384
// (24 x 128 + 240 x 256 = 64512; a budget past it leaves setmaxnreg.inc
// waiting forever); FB_DEPTH raw stages in flight
#define FB_PRODUCER_REGS 24
#define FB_CONSUMER_REGS 240
#define FB_DEPTH 4

// The float32 backward's tiles, both kernels: M is 64 rows (dK/dV: keys;
// dQ: query rows) against tiles of 64 on N (query rows; keys), D in
// chunks of 32 columns (one 128-byte swizzle row).  A tile's items, in the
// order the producer loads them into its stages: for each chunk c, the
// pair (A_c, B_c) of the first SS product (dK/dV: K_c, Q_c for S^T; dQ:
// Q_c, K_c for S) and the pair of the second (V_c, dO_c for dP^T; dO_c,
// V_c for dP), then for each half of N's 64 (32 rows, the K of the RS
// products) the two transposed B operands (dK/dV: dO^T, Q^T; dQ: K^T's
// two column halves).  Consumer warpgroup w takes the items of parity w
// and splits them into its own two 32 KB slots in turn.
template <int D>
struct FbT {
  static constexpr int DP = (D + 31) / 32 * 32;  // D padded to chunks
  static constexpr int NCH = DP / 32;            // chunks
  static constexpr int NI = 2 * NCH + 4;         // ring items a tile
  static constexpr int NKV = D > 128 ? 128 : D;  // dK/dV columns a CTA
  static constexpr int NHV = D / NKV;            // CTAs of a key tile
  static constexpr int NQ = D / 2;               // dQ columns a warpgroup
  static constexpr int SLOT = 32768;       // a split item
  static constexpr int STAGE = 16384;      // an item raw
  static constexpr int SIDE = 64 * 4;      // a stage's 64 lse or delta
  static constexpr int XBUF = 64 * 64 * 4;  // an exchange buffer
  static constexpr int THREADS = 3 * 128;
  // 1 KB of slack to align the swizzled tiles, two slots a consumer
  // warpgroup, FB_DEPTH raw stages and their side buffers, two exchange
  // buffers and the barriers: 231,680 bytes of the 232,448
  static constexpr int SMEM = 1024 + 4 * SLOT + FB_DEPTH * (STAGE + SIDE) +
                              2 * XBUF + 256;
};

// the width of an RS product over C output columns: C, or its two halves
// past 64 (a fresh sum of up to 32 registers beside the running 64)
template <int C>
struct FbRs {
  static constexpr int N = C > 64 ? C / 2 : C;
  static constexpr int H = C / N;
};

// the TMA box width of C output columns: boxes that tile C exactly
__host__ __device__ constexpr int fb_box(int c) {
  return c % 32 == 0 ? 32 : c % 16 == 0 ? 16 : 8;
}


// split_tf32's hi and lo by integer arithmetic, the same bits as
// cvt.rna.tf32.f32 (half of the dropped unit added to the magnitude's
// bits, the low 13 cleared: to nearest, ties away from zero), on the
// integer pipes: cvt runs on the conversion unit at a quarter of their
// rate, and the backward splits every operand of every tile
__device__ __forceinline__ void split_tf32_alu(float x, uint32_t& hi,
                                               uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void st_split(uint32_t hi, uint32_t lo,
                                         float4 v) {
  uint4 h, l;
  split_tf32_alu(v.x, h.x, l.x);
  split_tf32_alu(v.y, h.y, l.y);
  split_tf32_alu(v.z, h.z, l.z);
  split_tf32_alu(v.w, h.w, l.w);
  st_shared4(hi, h);
  st_shared4(lo, l);
}

__device__ __forceinline__ float2 lds_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];"
               : "=f"(v.x), "=f"(v.y)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ float4 ld_shared4f(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// `bytes` (a multiple of 16) from 16-byte aligned global memory into
// shared memory, counted on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// An item's loads go raw into a stage of FB_DEPTH by TMA (f32 maps, zeros
// past S and D), issued by one producer thread.

// A pair item: columns 32 c .. 32 c + 31 of 64 rows of a (the SS
// product's A, M's rows) and of 64 rows of b (its B), two boxes of 64 rows
// of 128 bytes: a's in the 128-byte swizzle at the stage, whence each
// thread takes its A fragments straight into registers (fb_load_a: 8 rows
// x 4 columns a load, in distinct banks), and b's as it is 8 KB further,
// where float4 u of thread tid sits at 8192 + 2048 u + 16 tid: row i / 8,
// float4 i % 8, i = tid + 128 u, split K-major (fb_put_b: hi at the slot,
// lo 8 KB further; 8 lanes take a row's 8 chunks, so reads and swizzled
// writes are free of bank conflicts).
__device__ __forceinline__ void fb_put_b(uint32_t stage, uint32_t slot,
                                         int tid) {
  // two float4s at a time: the split runs beside an accumulator in flight
#pragma unroll 2
  for (int u = 0; u < 4; ++u) {
    const int i = tid + 128 * u;
    const uint32_t hi = slot + swz128(64, i / 8, i % 8);
    st_split(hi, hi + 8192, ld_shared4f(stage + 8192 + u * 2048 + tid * 16));
  }
}

__device__ __forceinline__ float lds_f1(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

// the A fragments of KS k8 steps of a's swizzled box at the stage, split
// into TF32 hi and lo: a[e] of step kk is row rr + 8 (e % 2), column 8 kk
// + t + 4 (e / 2), t = lane % 4
template <int KS>
__device__ __forceinline__ void fb_load_a(uint32_t stage, int tid,
                                          uint32_t (&ah)[4][4],
                                          uint32_t (&al)[4][4]) {
  const int rr = 16 * (tid / 32) + (tid % 32) / 4, t = tid % 4;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = rr + 8 * (e % 2), col = 8 * kk + t + 4 * (e / 2);
      const uint32_t o = r * 128 + ((((col >> 2) ^ (r & 7)) << 4) |
                                    ((col & 3) << 2));
      split_tf32_alu(lds_f1(stage + o), ah[kk][e], al[kk][e]);
    }
}

// A transposed item: 32 rows of NC columns (one box, row-major at the
// stage) become NC rows of 32, the rows K-major (the B operand of an RS
// product summing over them), hi at the slot and lo NC x 128 bytes
// further.  The rows of each group of 8 are stored in the order 0 2 4 6 1
// 3 5 7, as put_v stores V^T's keys: the A fragment of a k8 step holds
// positions t and t + 4 where the accumulator it comes from holds columns
// 2t and 2t + 1.  A thread's item is chunk j (16 bytes: 4 source rows) of
// float4 c (4 destination rows): item t = tid + 128 u is lane l = t % 8 of
// step s = (t / 8) % 4 of block t / 32, whose chunks 4 (block % 2) .. and
// float4s 8 (block / 2) ..: c = 8 (block / 2) + l and j = 4 (block % 2) +
// (l / 2 + s) % 4.  So the 8 lanes of a phase read 8 float4s of distinct
// banks from their rows and write 8 distinct chunks of the swizzled rows.
template <int NC>
struct FbTItems {
  static constexpr int C4 = NC / 4;
  static_assert(NC % 4 == 0 && (C4 + 7) / 8 <= 4, "two items a thread");
  __device__ static __forceinline__ void at(int tid, int u, int& j,
                                            int& c) {
    const int t = tid + 128 * u, blk = t / 32, l = t % 8;
    c = 8 * (blk / 2) + l;
    j = 4 * (blk % 2) + (l / 2 + (t / 8) % 4) % 4;
  }
};

template <int NC>
__device__ __forceinline__ void fb_put_t(uint32_t stage, uint32_t slot,
                                         int tid) {
  using I = FbTItems<NC>;
#pragma unroll 1
  for (int u = 0; u < 2; ++u) {
    int j, c;
    I::at(tid, u, j, c);
    if (c >= I::C4) continue;
    float4 y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      y[i] = ld_shared4f(stage + (8 * (j / 2) + 2 * i + j % 2) * (NC * 4) +
                         c * 16);
    const float4 col[4] = {make_float4(y[0].x, y[1].x, y[2].x, y[3].x),
                           make_float4(y[0].y, y[1].y, y[2].y, y[3].y),
                           make_float4(y[0].z, y[1].z, y[2].z, y[3].z),
                           make_float4(y[0].w, y[1].w, y[2].w, y[3].w)};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t a = slot + swz128(NC, 4 * c + e, j);
      st_split(a, a + NC * 128, col[e]);
    }
  }
}

// descriptor d moved o bytes further into its tile (o a multiple of 16),
// formed where it is used: formed ahead, the descriptors of an item's 12
// products hold 24 registers, and ptxas spilled
__device__ __forceinline__ uint64_t desc_at(uint64_t d, uint32_t o) {
  uint64_t r;
  asm volatile("add.s64 %0, %1, %2;"
               : "=l"(r)
               : "l"(d), "l"(static_cast<uint64_t>(o >> 4)));
  return r;
}

// acc = A B^T of one pair item, A in registers (hi ah, lo al), B's 64
// rows of hi at the slot and lo 8 KB further: m64n64 over KS k8 steps, 3
// products each: a_hi b_lo and a_lo b_hi first into the fresh sum, where a
// truncation is small, then a_hi b_hi
template <int KS>
__device__ __forceinline__ void fb_issue_pair(float (&acc)[32],
                                              uint32_t (&ah)[4][4],
                                              uint32_t (&al)[4][4],
                                              uint32_t slot) {
  const uint64_t d = wgmma_desc(slot, 16, 1024);
  wgmma_pin(ah);
  wgmma_pin(al);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    wgmma_tf32_rs<64>(acc, ah[kk], desc_at(d, 8192 + 32 * kk), kk > 0);
    wgmma_tf32_rs<64>(acc, al[kk], desc_at(d, 32 * kk));
  }
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    wgmma_tf32_rs<64>(acc, ah[kk], desc_at(d, 32 * kk));
  wgmma_commit();
}

// part = A B over one chunk of 32 of K (4 k8 steps), A in registers (hi
// ah, lo al), B's N rows of hi at b and lo at b + lo: m64nN, 3 products a
// step, the cross terms first, into a fresh sum
template <int N>
__device__ __forceinline__ void fb_issue_rs(float (&part)[N / 2],
                                            uint32_t (&ah)[4][4],
                                            uint32_t (&al)[4][4],
                                            uint32_t b, uint32_t lo) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) part[i] = 0.f;
  wgmma_pin(part);
  wgmma_pin(ah);
  wgmma_pin(al);
  const uint64_t d = wgmma_desc(b, 16, 1024);
  wgmma_fence();
#pragma unroll
  for (int kt = 0; kt < 4; ++kt) {
    wgmma_tf32_rs<N>(part, ah[kt], desc_at(d, lo + kt * 32));
    wgmma_tf32_rs<N>(part, al[kt], desc_at(d, kt * 32));
  }
#pragma unroll
  for (int kt = 0; kt < 4; ++kt)
    wgmma_tf32_rs<N>(part, ah[kt], desc_at(d, kt * 32));
  wgmma_commit();
}

// the A fragments of the k8 steps over columns 32 Q .. 32 Q + 31 of an
// m64n64 accumulator's values (n8 blocks 4 Q ..), split into TF32 hi and
// lo in take_p's order
template <int Q>
__device__ __forceinline__ void fb_frags(const float (&v)[32],
                                         uint32_t (&ah)[4][4],
                                         uint32_t (&al)[4][4]) {
#pragma unroll
  for (int kt = 0; kt < 4; ++kt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      split_tf32_alu(v[4 * (4 * Q + kt) + (e % 2) * 2 + e / 2], ah[kt][e],
                     al[kt][e]);
}

// A warpgroup's 32 values of an m64n64 tile into an exchange buffer: the
// two consumer warpgroups hold the same elements in the same registers, so
// thread t reads what thread t wrote (float4 u at u 2048 + 16 t)
__device__ __forceinline__ void fb_put_x(uint32_t buf, const float (&v)[32],
                                         int tid) {
#pragma unroll
  for (int u = 0; u < 8; ++u)
    st_shared4(buf + u * 2048 + tid * 16,
               make_uint4(__float_as_uint(v[4 * u]),
                          __float_as_uint(v[4 * u + 1]),
                          __float_as_uint(v[4 * u + 2]),
                          __float_as_uint(v[4 * u + 3])));
}

// 64 rows of a warpgroup's NC output columns (an m64nNC accumulator's
// values times mul) into its staging buffer, blocks of W columns of 64
// rows of W floats (the TMA boxes), and out by TMA stores from column n0
// of rows row0 .. of (b, head), which drop rows past S.  Named barrier
// 2 + wg syncs the warpgroup's 128 threads.
template <int NC>
__device__ __forceinline__ void fb_store(const float (&acc)[NC / 2],
                                         float mul, uint32_t stage,
                                         const CUtensorMap* map, int n0,
                                         int head, int row0, int b, int wg,
                                         int tid) {
  constexpr int W = fb_box(NC);
  const int rr = 16 * (tid / 32) + (tid % 32) / 4, c2 = 2 * (tid % 4);
#pragma unroll
  for (int j = 0; j < NC / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = rr + 8 * r, col = 8 * j + c2;
      const uint32_t a = stage + (col / W) * 64 * W * 4 +
                         (row * W + col % W) * 4;
      asm volatile("st.shared.v2.f32 [%0], {%1, %2};" ::"r"(a),
                   "f"(acc[4 * j + 2 * r] * mul),
                   "f"(acc[4 * j + 2 * r + 1] * mul)
                   : "memory");
    }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("bar.sync %0, 128;" ::"r"(2 + wg) : "memory");
  if (tid == 0) {
    for (int c = 0; c < NC / W; ++c)
      tma_store_4d(map, stage + c * 64 * W * 4, n0 + c * W, head, row0, b);
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }
}

// The float32 backward, one CTA (kDQ false: dK/dV; true: dQ).  dK/dV: the
// CTA owns 64 keys of one (b, kv head) (and, at D 256, one half of dK and
// dV's columns) and walks every query head of the group in order, each
// from the key tile's causal start to the window's upper edge; dQ: 64
// query rows of one (b, h), the key tiles from the window's lower edge to
// the causal frontier.  Per tile (64 x 64), the producer thread loads the
// items raw by TMA into FB_DEPTH stages; consumer warpgroup 0 runs the
// first SS product chunk by chunk (dK/dV: S^T = K Q^T; dQ: S = Q K^T), A
// from the stage into registers and B split into its slot, each chunk
// into a fresh sum added to the tile's in f32, then P = exp(s - lse) with
// its softcap factor dc (tanhf), masked, and passes P dc to warpgroup 1
// through an exchange buffer; warpgroup 1 runs the second (dP^T = V dO^T;
// dP = dO V^T) and forms dS = P dc (dP - delta).  Then each runs its RS
// products over the tile's two halves of 32 (dK/dV: warpgroup 0 dV +=
// P^T dO, 1 dK += dS^T Q; dQ: each dQ += dS K over its half of the
// columns, warpgroup 1 passing dS back), each half (and each piece of
// columns) into a fresh sum added to the running one in f32: every long
// sum rounds to nearest, and the tensor cores' truncating adds stay inside
// 4 k8 steps.  Every sum runs in one fixed order: the same inputs give the
// same bits.
template <int D, bool kDQ, bool kWindow>
__device__ __forceinline__ void fb_body(
    const CUtensorMap* ta0, const CUtensorMap* ta1, const CUtensorMap* tb0,
    const CUtensorMap* tb1, const CUtensorMap* tt0, const CUtensorMap* tt1,
    const float* __restrict__ rows, const CUtensorMap* m0,
    const CUtensorMap* m1, int B, int S, int H, int KVH, float scale,
    float softcap, int window) {
  using T = FbT<D>;
  constexpr int NCH = T::NCH, NI = T::NI, ND = FB_DEPTH;
  constexpr int NC = kDQ ? T::NQ : T::NKV;  // a warpgroup's output columns
  constexpr int NXB = kDQ ? 1 : 2;          // P dc buffers
  using R = FbRs<NC>;
  extern __shared__ uint8_t fa_raw[];
  const uint32_t slots = (smem_u32(fa_raw) + 1023) & ~1023u;  // [2][2]
  const uint32_t stage0 = slots + 4 * T::SLOT;                 // [ND]
  const uint32_t side0 = stage0 + ND * T::STAGE;               // [ND]
  const uint32_t xbuf = side0 + ND * T::SIDE;                  // [2]
  const uint32_t raw_full = xbuf + 2 * T::XBUF;  // [ND] 8-byte barriers
  const uint32_t raw_empty = raw_full + 8 * ND;  // [ND]
  const uint32_t xfull = raw_empty + 8 * ND;     // [2]
  const uint32_t xempty = xfull + 16;            // [2]
  const int rep = H / KVH, S64 = (S + 63) / 64 * 64;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ND; ++s) {
      mbar_init(raw_full + 8 * s, 1);
      mbar_init(raw_empty + 8 * s, 128);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(xfull + 8 * s, 128);
      mbar_init(xempty + 8 * s, 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // the CTA's M tile and walk (tile n: head h, query rows q0 .., keys
  // kk0 ..), formed in each warpgroup after its setmaxnreg from its own
  // read of the CTA index: formed before, its values live across the
  // producer's 24 registers and ptxas spills them
  int b, kvh, half = 0, m_h = 0, m_q0 = 0, k0 = 0, nqt = 0, lo = 0;
  int n_tiles;
  auto walk = [&]() {
    uint32_t cta;
    asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(cta));
    if constexpr (kDQ) {
      const int nq = (S + 63) / 64;
      const int bh = static_cast<int>(cta % (B * H));
      b = bh / H;
      m_h = bh % H;
      kvh = m_h / rep;
      m_q0 = (nq - 1 - static_cast<int>(cta / (B * H))) * 64;
      lo = kWindow ? max(0, m_q0 - window + 1) / 64 : 0;
      n_tiles = (min(m_q0 + 64, S) + 63) / 64 - lo;
    } else {
      const int per = B * KVH * T::NHV;
      const int rem = static_cast<int>(cta % per);
      k0 = static_cast<int>(cta / per) * 64;
      half = rem % T::NHV;
      kvh = rem / T::NHV % KVH;
      b = rem / T::NHV / KVH;
      const int q_end = kWindow ? min(S, k0 + 63 + window) : S;
      nqt = (q_end - k0 + 63) / 64;
      n_tiles = rep * nqt;
    }
  };
  auto tile = [&](int n, int& h, int& q0, int& kk0) {
    if constexpr (kDQ) {
      h = m_h;
      q0 = m_q0;
      kk0 = (lo + n) * 64;
    } else {
      h = kvh * rep + n / nqt;
      q0 = k0 + (n % nqt) * 64;
      kk0 = k0;
    }
  };

  if (threadIdx.x >= 256) {
    // producer, one thread: item g of the walk (g / NI its tile) loaded raw
    // into stage g % ND by TMA once the warpgroup that split the item ND
    // before it released the stage; the stage's full barrier completes
    // when the bytes land.  A pair: two 64-row boxes of 32 columns (and
    // for dK/dV each warpgroup's last pair of a tile its 64 lse (warpgroup
    // 0) or delta (1), one bulk copy); a transposed item: one 32-row box of
    // the warpgroup's NC columns
    regs_dealloc<FB_PRODUCER_REGS>();
    if (threadIdx.x != 256) return;
    walk();
    const int total = n_tiles * NI;
#pragma unroll 1
    for (int g = 0; g < total; ++g) {
      const int i = g % NI, s = g % ND;
      const uint32_t st = stage0 + s * T::STAGE;
      const uint32_t bar = raw_full + 8 * s;
      int h, q0, kk0;
      tile(g / NI, h, q0, kk0);
      if (g >= ND) mbar_wait(raw_empty + 8 * s, ((g / ND) - 1) & 1);
      if (i < 2 * NCH) {
        const bool two = i % 2;  // the second product's pair
        const bool with_rows = !kDQ && i >= 2 * NCH - 2;
        const int col = 32 * (i / 2);
        mbar_expect_tx(bar, 16384 + (with_rows ? 256 : 0));
        tma_load_4d(st, two ? ta1 : ta0, bar, col, kDQ ? h : kvh,
                    kDQ ? q0 : kk0, b);
        tma_load_4d(st + 8192, two ? tb1 : tb0, bar, col, kDQ ? kvh : h,
                    kDQ ? kk0 : q0, b);
        if (with_rows)
          bulk_load(side0 + s * T::SIDE,
                    rows + (static_cast<long long>(b) * H + h) * 2 * S64 +
                        2 * q0 + 64 * (i % 2),
                    256, bar);
      } else {
        const int j = i - 2 * NCH, r = 32 * (j / 2);
        mbar_expect_tx(bar, 32 * NC * 4);
        if constexpr (kDQ)
          tma_load_4d(st, tt0, bar, (j % 2) * NC, kvh, kk0 + r, b);
        else
          tma_load_4d(st, j % 2 ? tt1 : tt0, bar, half * 128, h, q0 + r, b);
      }
    }
    return;
  }

  // consumers: this thread holds M rows rr and rr + 8 of a 64 x N tile, at
  // columns 8 j + c2 + {0, 1} of each n8 block j (wgmma's f32 layout).
  // Each warpgroup splits its own items from their stages into its two
  // slots in turn (m counts its items), the next item's split running
  // under the last one's products
  regs_alloc<FB_CONSUMER_REGS>();
  walk();
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int c2 = 2 * (tid % 4), rr = 16 * (tid / 32) + (tid % 32) / 4;
  const float cs = scale * FA_LOG2E;
  const float to_cap = softcap > 0.f ? scale / softcap : 0.f;
  float out[NC / 2];
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) out[i] = 0.f;
  int m = 0;
  auto slot_of = [&](int mm) {
    return slots + (2 * wg + (mm & 1)) * T::SLOT;
  };
  // item g's split into the slot: its B (a pair's b; a transposed item
  // whole) stored in hi and lo and visible to the tensor cores (the
  // warpgroup's 128 threads' stores fenced and synced); a transposed
  // item's stage is released, a pair's once its A is loaded (done_a)
  auto split = [&](int g, uint32_t slot, bool pair) {
    const int s = g % ND;
    const uint32_t st = stage0 + s * T::STAGE;
    mbar_wait(raw_full + 8 * s, (g / ND) & 1);
    if (pair) {
      fb_put_b(st, slot, tid);
    } else {
      fb_put_t<NC>(st, slot, tid);
      mbar_arrive(raw_empty + 8 * s);
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync %0, 128;" ::"r"(2 + wg) : "memory");
  };
  // once pair item g's A fragments are in registers (fb_load_a), its stage
  // released; with want_cv (dK/dV's last pair item of a tile) first the lse
  // (warpgroup 0, as -lse log2 e) or delta (1) of the thread's 16 query
  // columns, from the stage's side buffer
  auto done_a = [&](int g, bool want_cv, float (&cv)[16]) {
    const int s = g % ND;
    if (want_cv) {
      const uint32_t sd = side0 + s * T::SIDE;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l2 = lds_f2(sd + 4 * (8 * j + c2));
        cv[2 * j] = wg == 0 ? -l2.x * FA_LOG2E : l2.x;
        cv[2 * j + 1] = wg == 0 ? -l2.y * FA_LOG2E : l2.y;
      }
    }
    mbar_arrive(raw_empty + 8 * s);
  };
  // dQ: the lse (warpgroup 0, as -lse log2 e) or delta (1) of the
  // thread's two rows, from the rows kernel's tiles
  float rv[2] = {0.f, 0.f};
  if constexpr (kDQ) {
    const float* t = rows + (static_cast<long long>(b) * H + m_h) * 2 * S64 +
                     2 * m_q0 + 64 * wg;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      rv[r] = wg == 0 ? -t[rr + 8 * r] * FA_LOG2E : t[rr + 8 * r];
  }

  for (int n = 0; n < n_tiles; ++n) {
    int h, q0, kk0;
    tile(n, h, q0, kk0);
    const int gb = n * NI + wg;  // this warpgroup's items: gb + 2 i
    float run[32], cv[16];
    // the SS product over the chunks, each chunk's sum apart in acc (the
    // cross terms first) and added to run in f32; chunk c + 1 is split
    // while chunk c's products run
    {
      float acc[32];
      uint32_t ah[4][4], al[4][4];  // read by the products in flight
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const uint32_t slot = slot_of(m + c);
        const int g = gb + 2 * c;
        split(g, slot, true);
        if (c > 0) {
          wgmma_wait<0>();
          wgmma_pin(acc);
          wgmma_pin(ah);
          wgmma_pin(al);
#pragma unroll
          for (int i = 0; i < 32; ++i)
            run[i] = c == 1 ? acc[i] : run[i] + acc[i];
        }
        const uint32_t st = stage0 + (g % ND) * T::STAGE;
        if (32 * c + 32 <= D) {
          fb_load_a<4>(st, tid, ah, al);
          done_a(g, !kDQ && c == NCH - 1, cv);
          fb_issue_pair<4>(acc, ah, al, slot);
        } else {
          constexpr int KS = (D % 32) / 8;
          fb_load_a<KS>(st, tid, ah, al);
          done_a(g, !kDQ && c == NCH - 1, cv);
          fb_issue_pair<KS>(acc, ah, al, slot);
        }
      }
      // the first transposed item split under the last chunk's products
      split(gb + 2 * NCH, slot_of(m + NCH), false);
      wgmma_wait<0>();
      wgmma_pin(acc);
      wgmma_pin(ah);
      wgmma_pin(al);
#pragma unroll
      for (int i = 0; i < 32; ++i) run[i] = NCH == 1 ? acc[i] : run[i] + acc[i];
    }
    split(gb + 2 * NCH + 2, slot_of(m + NCH + 1), false);
    // tiles with a key past a row, a row past S or a key at or below a
    // row's window edge are masked (P = 0)
    const bool edge =
        kDQ ? (kk0 + 63 > q0 || q0 + 64 > S ||
               (kWindow && kk0 + window <= q0 + 63))
            : (q0 < kk0 + 63 || q0 + 64 > S ||
               (kWindow && kk0 + window <= q0 + 63));
    const int xb = n % NXB, xu = n / NXB;
    const uint32_t px = xbuf + xb * T::XBUF;
    if (wg == 0) {
      // P = exp(s - lse) and its softcap factor, s = raw scale (with a
      // softcap, cap tanh(raw scale / cap)); P dc to warpgroup 1
      if (xu > 0) mbar_wait(xempty + 8 * xb, (xu - 1) & 1);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        float pd[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * u + e;
          const int mrow = rr + 8 * ((i / 2) % 2);
          const int ncol = 8 * (i / 4) + c2 + i % 2;
          const int row = kDQ ? q0 + mrow : q0 + ncol;
          const int key = kDQ ? kk0 + ncol : kk0 + mrow;
          const float nl = kDQ ? rv[(i / 2) % 2] : cv[2 * (i / 4) + i % 2];
          float p, dc = 1.f;
          if (softcap > 0.f) {
            const float t = tanhf(run[i] * to_cap);
            dc = 1.f - t * t;
            p = ex2_approx(fmaf(softcap * t, FA_LOG2E, nl));
          } else {
            p = ex2_approx(fmaf(run[i], cs, nl));
          }
          if (edge && (key > row || row >= S ||
                       (kWindow && key + window <= row)))
            p = 0.f;
          run[i] = p;
          pd[e] = p * dc;
        }
        st_shared4(px + u * 2048 + tid * 16,
                   make_uint4(__float_as_uint(pd[0]), __float_as_uint(pd[1]),
                              __float_as_uint(pd[2]), __float_as_uint(pd[3])));
      }
      mbar_arrive(xfull + 8 * xb);
      if constexpr (kDQ) {
        // dS back from warpgroup 1
        const uint32_t dx = xbuf + T::XBUF;
        mbar_wait(xfull + 8, n & 1);
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const float4 t = ld_shared4f(dx + u * 2048 + tid * 16);
          run[4 * u] = t.x;
          run[4 * u + 1] = t.y;
          run[4 * u + 2] = t.z;
          run[4 * u + 3] = t.w;
        }
        mbar_arrive(xempty + 8);
      }
    } else {
      // dS = P dc (dP - delta)
      mbar_wait(xfull + 8 * xb, xu & 1);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float4 t = ld_shared4f(px + u * 2048 + tid * 16);
        const float pd[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * u + e;
          const float dl = kDQ ? rv[(i / 2) % 2] : cv[2 * (i / 4) + i % 2];
          run[i] = pd[e] * (run[i] - dl);
        }
      }
      mbar_arrive(xempty + 8 * xb);
      if constexpr (kDQ) {
        const uint32_t dx = xbuf + T::XBUF;
        if (n > 0) mbar_wait(xempty + 8, (n - 1) & 1);
        fb_put_x(dx, run, tid);
        mbar_arrive(xfull + 8);
      }
    }
    // the RS products over the tile's two halves of 32 (N's), each piece
    // of output columns into a fresh sum added to out
#pragma unroll
    for (int hq = 0; hq < 2; ++hq) {
      uint32_t ah[4][4], al[4][4];
      if (hq == 0)
        fb_frags<0>(run, ah, al);
      else
        fb_frags<1>(run, ah, al);
      const uint32_t slot = slot_of(m + NCH + hq);
#pragma unroll
      for (int hh = 0; hh < R::H; ++hh) {
        float part[R::N / 2];
        fb_issue_rs<R::N>(part, ah, al, slot + hh * R::N * 128, NC * 128);
        wgmma_wait<0>();
        wgmma_pin(part);
#pragma unroll
        for (int i = 0; i < R::N / 2; ++i) out[hh * R::N / 2 + i] += part[i];
      }
    }
    m += NCH + 2;
  }

  // epilogue: both warpgroups' products are done, so their slots are
  // free: each stages its 64 rows of NC columns in its own 64 KB (dK and
  // dQ times 1/sqrt(D))
  asm volatile("bar.sync 1, 256;" ::: "memory");
  const uint32_t stage = slots + 2 * wg * T::SLOT;
  if constexpr (kDQ)
    fb_store<NC>(out, scale, stage, m0, wg * NC, m_h, m_q0, b, wg, tid);
  else
    fb_store<NC>(out, wg ? scale : 1.f, stage, wg ? m1 : m0, half * 128,
                 kvh, k0, b, wg, tid);
}

// ta0, ta1: the A operands of the two SS products (dK/dV: K, V; dQ: Q,
// dO), 64-row boxes of 32 columns in the 128-byte swizzle; tb0, tb1 their
// B operands (dK/dV: Q, dO; dQ: K, V), the same boxes as they are; tt0,
// tt1: 32-row boxes of a warpgroup's columns, the transposed items'
// sources (dK/dV: dO, Q; dQ: K)
template <int D, bool kWindow>
__global__ void __launch_bounds__(FbT<D>::THREADS, 1)
    flash_attention_bwd_tf32_dkdv_kernel(
        const __grid_constant__ CUtensorMap ta0,
        const __grid_constant__ CUtensorMap ta1,
        const __grid_constant__ CUtensorMap tb0,
        const __grid_constant__ CUtensorMap tb1,
        const __grid_constant__ CUtensorMap tt0,
        const __grid_constant__ CUtensorMap tt1,
        const float* __restrict__ rows,
        const __grid_constant__ CUtensorMap tdv,
        const __grid_constant__ CUtensorMap tdk, int B, int S, int H,
        int KVH, float scale, float softcap, int window) {
  fb_body<D, false, kWindow>(&ta0, &ta1, &tb0, &tb1, &tt0, &tt1, rows, &tdv,
                             &tdk, B, S, H, KVH, scale, softcap, window);
}

template <int D, bool kWindow>
__global__ void __launch_bounds__(FbT<D>::THREADS, 1)
    flash_attention_bwd_tf32_dq_kernel(
        const __grid_constant__ CUtensorMap ta0,
        const __grid_constant__ CUtensorMap ta1,
        const __grid_constant__ CUtensorMap tb0,
        const __grid_constant__ CUtensorMap tb1,
        const __grid_constant__ CUtensorMap tt0,
        const float* __restrict__ rows,
        const __grid_constant__ CUtensorMap tdq, int B, int S, int H,
        int KVH, float scale, float softcap, int window) {
  fb_body<D, true, kWindow>(&ta0, &ta1, &tb0, &tb1, &tt0, &tt0, rows, &tdq,
                            &tdq, B, S, H, KVH, scale, softcap, window);
}

// a float32 (B, S, heads, D) tensor as a rank-4 map over (D, heads, S, B),
// boxes of `cols` columns x 1 head x `rows` rows, with or without the
// 128-byte swizzle (32 columns): loads read zeros outside the tensor,
// stores drop what falls outside it
static int encode_bhsd_f32(EncodeTiledFn encode, CUtensorMap* map,
                           const void* x, int B, int S, int heads, int D,
                           int cols, int rows = 64, bool swizzle = false) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {4ull * D, 4ull * D * heads,
                                 4ull * D * heads * S};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(x), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : FA_ENCODE_FAILED;
}

// the float32 backward: the rows' lse and delta in tiles (into `rows`,
// 2 B H S64 floats), then dK/dV (a CTA per 64 keys of a (b, kv head), and
// per half of the columns at D 256; key tile 0, which sees every query
// tile, first), then dQ (a CTA per 64 query rows of a (b, h), the last
// query tile, which sees every key tile, first)
template <int D>
static int launch_fb_tf32(const void* q, const void* k, const void* v,
                          const void* o, const float* lse, const void* dout,
                          void* dq, void* dk, void* dv, float* rows, int B,
                          int S, int H, int KVH, float softcap, int window,
                          cudaStream_t stream) {
  using T = FbT<D>;
  if (B == 0 || S == 0) return 0;
  const EncodeTiledFn encode = tensor_map_encoder();
  if (encode == nullptr) return FA_NO_ENCODER;
  // each of q, k, v and dout as an SS product's swizzled A (s) and as its
  // B, and as the transposed items' source (t)
  CUtensorMap qs, ks, vs, dos, qb, kb, vb, dob, qt, dot, kt, mdq, mdk, mdv;
  const void* src4[4] = {q, k, v, dout};
  CUtensorMap* as4[4] = {&qs, &ks, &vs, &dos};
  CUtensorMap* bs4[4] = {&qb, &kb, &vb, &dob};
  int rc = 0;
  for (int x = 0; x < 4 && rc == 0; ++x) {
    const int heads = x == 1 || x == 2 ? KVH : H;
    rc = encode_bhsd_f32(encode, as4[x], src4[x], B, S, heads, D, 32, 64,
                         true);
    if (rc == 0)
      rc = encode_bhsd_f32(encode, bs4[x], src4[x], B, S, heads, D, 32);
  }
  if (rc == 0) rc = encode_bhsd_f32(encode, &qt, q, B, S, H, D, T::NKV, 32);
  if (rc == 0)
    rc = encode_bhsd_f32(encode, &dot, dout, B, S, H, D, T::NKV, 32);
  if (rc == 0) rc = encode_bhsd_f32(encode, &kt, k, B, S, KVH, D, T::NQ, 32);
  if (rc == 0)
    rc = encode_bhsd_f32(encode, &mdq, dq, B, S, H, D, fb_box(T::NQ));
  if (rc == 0)
    rc = encode_bhsd_f32(encode, &mdk, dk, B, S, KVH, D, fb_box(T::NKV));
  if (rc == 0)
    rc = encode_bhsd_f32(encode, &mdv, dv, B, S, KVH, D, fb_box(T::NKV));
  if (rc != 0) return rc;
  const int S64 = (S + 63) / 64 * 64;
  const long long n = static_cast<long long>(B) * S64 * H;
  const long long tiles = (S + 63) / 64;
  const long long kv_ctas = static_cast<long long>(B) * KVH * T::NHV * tiles;
  const long long q_ctas = static_cast<long long>(B) * H * tiles;
  if ((n + 7) / 8 > 2147483647LL || kv_ctas > 2147483647LL ||
      q_ctas > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  flash_attention_bwd_rows_kernel<float>
      <<<static_cast<unsigned>((n + 7) / 8), 256, 0, stream>>>(
          static_cast<const float*>(o), static_cast<const float*>(dout), lse,
          rows, S, S64, H, D, n);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  // a window of S keys or more is no window: the causal instances
  const bool win = window > 0 && window < S;
  auto dkdv = win ? flash_attention_bwd_tf32_dkdv_kernel<D, true>
                  : flash_attention_bwd_tf32_dkdv_kernel<D, false>;
  auto dqk = win ? flash_attention_bwd_tf32_dq_kernel<D, true>
                 : flash_attention_bwd_tf32_dq_kernel<D, false>;
  cudaError_t err = cudaFuncSetAttribute(
      dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv<<<static_cast<unsigned>(kv_ctas), T::THREADS, T::SMEM, stream>>>(
      ks, vs, qb, dob, dot, qt, rows, mdv, mdk, B, S, H, KVH, scale, softcap,
      window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dqk<<<static_cast<unsigned>(q_ctas), T::THREADS, T::SMEM, stream>>>(
      qs, dos, kb, vb, kt, rows, mdq, B, S, H, KVH, scale, softcap, window);
  return static_cast<int>(cudaGetLastError());
}

static int dispatch_fb_tf32(const void* q, const void* k, const void* v,
                            const void* o, const float* lse,
                            const void* dout, void* dq, void* dk, void* dv,
                            float* rows, int B, int S, int H, int KVH, int D,
                            float softcap, int window, cudaStream_t st) {
#define FB_TF32(DD)                                                        \
  case DD:                                                                 \
    return launch_fb_tf32<DD>(q, k, v, o, lse, dout, dq, dk, dv, rows, B, \
                              S, H, KVH, softcap, window, st)
  switch (D) {
    FB_TF32(16);
    FB_TF32(32);
    FB_TF32(64);
    FB_TF32(96);
    FB_TF32(112);
    FB_TF32(128);
    FB_TF32(256);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FB_TF32
}

// ---------------------------------------------------------------------------
// K8 backward, bfloat16: wgmma, TMA and an mbarrier ring
// ---------------------------------------------------------------------------

// the dK/dV kernel's tiles: a CTA owns BKV keys of one (b, kv head) and
// walks query tiles of BQ rows; two consumer warpgroups own 64 keys each
// (DP <= 128) or the same 64 keys and 128 columns each (DP = 256)
template <int DP>
struct FabDkdv {
  static constexpr int BKV = DP > 128 ? 64 : 128;  // keys of a CTA
  static constexpr int BQ = 64;                     // rows of a query tile
  static constexpr int STAGES = DP > 128 ? 2 : 3;   // Q/dO ring depth
  static constexpr int NB = DP / 64;                // 64-column blocks
  static constexpr int KV_BYTES = BKV * DP * 2;     // the K or the V tile
  static constexpr int QT_BYTES = BQ * DP * 2;      // a Q or a dO tile
  static constexpr int ROW_BYTES = BQ * 4;          // a tile's lse or delta
  static constexpr int O_COLS = DP > 128 ? 128 : DP;
  static constexpr int O_BYTES = 64 * O_COLS * 2;   // one warpgroup's staging
  static constexpr int THREADS = 3 * 128;
  // 1 KB of slack to align the swizzled tiles, K, V, the Q and dO rings,
  // the dK/dV staging, the lse/delta ring and the barriers
  static constexpr int SMEM = 1024 + 2 * KV_BYTES + 2 * STAGES * QT_BYTES +
                              2 * O_BYTES + 2 * STAGES * ROW_BYTES + 256;
};

// the dQ kernel's tiles: a CTA owns BQ query rows of one (b, h), two
// consumer warpgroups of 64, and walks key tiles of BK keys
template <int DP>
struct FabDq {
  static constexpr int BQ = 128;
  static constexpr int BK = DP > 128 ? 32 : 64;   // keys per tile
  static constexpr int STAGES = DP > 128 ? 2 : 4;  // K/V ring depth
  static constexpr int NB = DP / 64;
  static constexpr int Q_BYTES = BQ * DP * 2;     // the Q or the dO tile
  static constexpr int KV_BYTES = BK * DP * 2;    // one K or V tile
  static constexpr int O_COLS = DP > 128 ? 128 : DP;
  static constexpr int O_BYTES = 64 * O_COLS * 2;
  static constexpr int THREADS = 3 * 128;
  static constexpr int SMEM =
      1024 + 2 * Q_BYTES + 2 * STAGES * KV_BYTES + 2 * O_BYTES + 256;
};

// x, hidden from the compiler: what is formed from it is formed where it
// is used, not held in registers across a loop
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

// the probability of one score and the factor of its softcap: raw = q.k
// unscaled, nl = -lse log2 e; P = exp(s - lse) = 2^(raw c + nl) with
// c = scale log2 e, or with a softcap s = cap t, t = tanh(raw scale / cap),
// P = 2^(s log2 e + nl) and dc = 1 - t^2 (else 1)
__device__ __forceinline__ float fab_prob(float raw, float nl, float c,
                                          float softcap, float to_cap,
                                          float& dc) {
  if (softcap > 0.f) {
    const float t = tanh_fast(raw * to_cap);
    dc = 1.f - t * t;
    return ex2_approx(fmaf(softcap * t, FA_LOG2E, nl));
  }
  dc = 1.f;
  return ex2_approx(fmaf(raw, c, nl));
}

// 64 rows of one warpgroup's f32 accumulator (N / 2 registers a thread,
// rows rr and rr + 8, columns 8 j + c2 + {0, 1}) times `mul`, rounded once
// to bf16 into the warpgroup's staging buffer (128-byte swizzle) and
// written by TMA stores of 64 columns from column n0 of rows row0 .. of
// (b, head), which drop rows >= S and columns >= D; up to 128 columns a
// pass, each first waiting until the previous stores have read the buffer.
// Named barrier 3 + wg syncs the warpgroup's 128 threads.
template <int N>
__device__ __forceinline__ void fab_store(const float (&acc)[N / 2],
                                          float mul, uint32_t so_wg,
                                          const CUtensorMap* map, int n0,
                                          int head, int row0, int b, int D,
                                          int wg, int tid) {
  const int rr = 16 * (tid / 32) + (tid % 32) / 4, c2 = 2 * (tid % 4);
#pragma unroll
  for (int pass = 0; pass < N / 8; pass += 16) {
    if (tid == 0)
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    asm volatile("bar.sync %0, 128;" ::"r"(3 + wg) : "memory");
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = rr + 8 * r;
#pragma unroll
      for (int jj = 0; jj < 16 && pass + jj < N / 8; ++jj) {
        const int j = pass + jj;
        const uint32_t dst = so_wg + (jj / 8) * 64 * 128 + row * 128 +
                             (((jj % 8) ^ (row % 8)) * 16) + c2 * 2;
        const uint32_t val = pack_bf16x2(acc[4 * j + 2 * r] * mul,
                                         acc[4 * j + 2 * r + 1] * mul);
        asm volatile("st.shared.u32 [%0], %1;" ::"r"(dst), "r"(val)
                     : "memory");
      }
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync %0, 128;" ::"r"(3 + wg) : "memory");
    if (tid == 0) {
      for (int c = 0; c < 2 && 8 * pass + 64 * c < N; ++c)
        if (n0 + 8 * pass + 64 * c < D)
          tma_store_4d(map, so_wg + c * 64 * 128, n0 + 8 * pass + 64 * c,
                       head, row0, b);
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
  }
}

// dK and dV of BKV keys of one (b, kv head), the keys as the products' M:
// the CTA walks every query head of the kv head's group in order and, for
// each, the query tiles from the key tile's causal start to the window's
// upper edge; for each, S^T = K Q^T and dP^T = V dO^T (both SS, K-major),
// P^T = exp(s - lse) and dS^T = P^T (dP^T - delta) (1 - t^2) in f32
// registers, both rounded to bf16 where the accumulator's layout is the A
// fragment, then dV += P^T dO and dK += dS^T Q (RS, dO and Q MN-major).
// The heads and tiles sum in one fixed order, without atomics.  Persistent:
// a CTA walks units of two key tiles (nk - 1 - i, i) of one (b, kv head),
// which see the same number of query tiles (fa_next_tile).  DN: the
// products' width over D, as the forward's.
template <int DP, int DN, bool kWindow>
__global__ void __launch_bounds__(FabDkdv<DP>::THREADS, 1)
    flash_attention_bwd_wgmma_dkdv_kernel(
        const __grid_constant__ CUtensorMap tq,
        const __grid_constant__ CUtensorMap tk,
        const __grid_constant__ CUtensorMap tv,
        const __grid_constant__ CUtensorMap tdo,
        const __grid_constant__ CUtensorMap tdk,
        const __grid_constant__ CUtensorMap tdv,
        const float* __restrict__ rows, int B, int S, int H, int KVH, int D,
        float scale, float softcap, int window) {
  using T = FabDkdv<DP>;
  constexpr int BKV = T::BKV, BQ = T::BQ, ST = T::STAGES, NB = T::NB;
  // a warpgroup's keys start KR rows into the K tile; its dK/dV columns
  // are NW wide (DN, or its half of 256)
  constexpr int KR = DP > 128 ? 0 : 64;
  constexpr int NW = DP > 128 ? 128 : DN;
  extern __shared__ uint8_t fa_raw[];
  const uint32_t sk = (smem_u32(fa_raw) + 1023) & ~1023u;  // K
  const uint32_t sv = sk + T::KV_BYTES;                    // V
  const uint32_t sq = sv + T::KV_BYTES;                    // Q ring
  const uint32_t sdo = sq + ST * T::QT_BYTES;              // dO ring
  const uint32_t so = sdo + ST * T::QT_BYTES;              // staging [2]
  const uint32_t srow = so + 2 * T::O_BYTES;  // [ST] lse, then delta
  const uint32_t kv_full = srow + 2 * ST * T::ROW_BYTES;
  const uint32_t kv_empty = kv_full + 8;
  const uint32_t full = kv_empty + 8;   // [ST] a query tile landed
  const uint32_t empty = full + 8 * ST;  // [ST] consumers done with it

  const int nk = (S + BKV - 1) / BKV;  // key tiles of a kv head
  const int n_units = B * KVH * ((nk + 1) / 2);
  const int rep = H / KVH;
  const int wg = threadIdx.x / 128;
  auto q_end = [&](int k0) {  // query rows that see a key of the tile
    return kWindow ? min(S, k0 + BKV - 1 + window) : S;
  };

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, 2 * 128);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one thread.  Per key tile: K and V once the consumers are
    // done with the last ones, then every query tile's Q, dO and its rows'
    // lse and delta (one bulk copy of their 64-row tile) through the ring,
    // a stage refilled once both consumer warpgroups released it
    regs_dealloc<24>();
    if (threadIdx.x != 256) return;
    const int S64 = (S + 63) / 64 * 64;
    int items = 0, g = 0, b, kvh, kt;
    for (int j = 0; fa_next_tile(j, nk, n_units, KVH, b, kvh, kt); ++j) {
      const int k0 = kt * BKV, qe = q_end(k0);
      if (items > 0) mbar_wait(kv_empty, (items - 1) & 1);
      mbar_expect_tx(kv_full, 2 * T::KV_BYTES);
      for (int c = 0; c < NB; ++c) {
        tma_load_4d(sk + c * BKV * 128, &tk, kv_full, 64 * c, kvh, k0, b);
        tma_load_4d(sv + c * BKV * 128, &tv, kv_full, 64 * c, kvh, k0, b);
      }
      for (int hr = 0; hr < rep; ++hr) {
        const int h = kvh * rep + hr;
        const float* hrows =
            rows + (static_cast<long long>(b) * H + h) * 2 * S64;
        for (int q0 = k0; q0 < qe; q0 += BQ, ++g) {
          const int s = g % ST;
          if (g >= ST) mbar_wait(empty + 8 * s, ((g / ST) - 1) & 1);
          const uint32_t f = full + 8 * s;
          mbar_expect_tx(f, 2 * T::QT_BYTES + 2 * T::ROW_BYTES);
          for (int c = 0; c < NB; ++c) {
            tma_load_4d(sq + s * T::QT_BYTES + c * BQ * 128, &tq, f, 64 * c,
                        h, q0, b);
            tma_load_4d(sdo + s * T::QT_BYTES + c * BQ * 128, &tdo, f,
                        64 * c, h, q0, b);
          }
          bulk_load(srow + s * 2 * T::ROW_BYTES, hrows + 2 * q0,
                    2 * T::ROW_BYTES, f);
        }
      }
      ++items;
    }
    return;
  }

  // consumers: this thread holds keys key0 and key0 + 8 of its
  // warpgroup's 64 and, of the query tile, columns 8 j + c2 + {0, 1}
  regs_alloc<240>();
  const int tid = threadIdx.x % 128;
  const int c2 = 2 * (tid % 4);
  const int rr = 16 * (tid / 32) + (tid % 32) / 4;
  const uint32_t ka0 = sk + wg * KR * 128, va0 = sv + wg * KR * 128;
  const int n0 = DP > 128 ? 128 * wg : 0;  // first dK/dV column
  const uint32_t nb = (n0 / 64) * BQ * 128;  // its offset in a Q/dO tile
  const float c = scale * FA_LOG2E;
  const float to_cap = softcap > 0.f ? scale / softcap : 0.f;
  float dv[NW / 2], dk[NW / 2];
  int items = 0, g = 0, b, kvh, kt;
  for (int j = 0; fa_next_tile(j, nk, n_units, KVH, b, kvh, kt);
       ++j, ++items) {
    const int k0 = kt * BKV, wk0 = k0 + wg * KR, qe = q_end(k0);
    const int key0 = wk0 + rr;
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) dv[i] = dk[i] = 0.f;
    mbar_wait(kv_full, items & 1);
    for (int hr = 0; hr < rep; ++hr) {
      for (int q0 = k0; q0 < qe; q0 += BQ, ++g) {
        const int s = g % ST;
        mbar_wait(full + 8 * s, (g / ST) & 1);
        // no key of this warpgroup visible to a row of the tile
        const bool skip = wk0 >= S || q0 + BQ - 1 < wk0 ||
                          (kWindow && wk0 + 63 + window <= q0);
        if (!skip) {
          const uint32_t ka = opaque(ka0), va = opaque(va0);
          const uint32_t qb = sq + s * T::QT_BYTES;
          const uint32_t dob = sdo + s * T::QT_BYTES;
          const uint32_t ls = srow + s * 2 * T::ROW_BYTES;
          float st[32], dpt[32];
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < DN / 16; ++kk) {
            const uint32_t o = (kk % 4) * 32;
            wgmma_ss<64>(st,
                         wgmma_desc(ka + (kk / 4) * BKV * 128 + o, 16, 1024),
                         wgmma_desc(qb + (kk / 4) * BQ * 128 + o, 16, 1024),
                         kk > 0);
          }
          wgmma_commit();
#pragma unroll
          for (int kk = 0; kk < DN / 16; ++kk) {
            const uint32_t o = (kk % 4) * 32;
            wgmma_ss<64>(dpt,
                         wgmma_desc(va + (kk / 4) * BKV * 128 + o, 16, 1024),
                         wgmma_desc(dob + (kk / 4) * BQ * 128 + o, 16, 1024),
                         kk > 0);
          }
          wgmma_commit();
          // a key past a row, a key or a row past S, or (kWindow) a key at
          // or below a row's window edge: P = 0
          const bool edge = q0 < wk0 + 63 || q0 + BQ > S || wk0 + 64 > S ||
                            (kWindow && wk0 + window <= q0 + BQ - 1);
          uint32_t pa[4][4], da[4][4];
          wgmma_wait<1>();  // S^T is done, dP^T may still run
          wgmma_pin(st);
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const float2 L = lds_f2(ls + 4 * (8 * jj + c2));
            const float nl[2] = {-L.x * FA_LOG2E, -L.y * FA_LOG2E};
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              float p[2];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int i = 4 * jj + 2 * r + e;
                float dc;
                p[e] = fab_prob(st[i], nl[e], c, softcap, to_cap, dc);
                if (edge) {
                  const int key = key0 + 8 * r, row = q0 + 8 * jj + c2 + e;
                  if (key > row || row >= S || key >= S ||
                      (kWindow && key + window <= row))
                    p[e] = 0.f;
                }
                st[i] = p[e] * dc;
              }
              pa[jj / 2][2 * (jj % 2) + r] = pack_bf16x2(p[0], p[1]);
            }
          }
          wgmma_wait<0>();
          wgmma_pin(dpt);
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const float2 dl = lds_f2(ls + T::ROW_BYTES + 4 * (8 * jj + c2));
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int i = 4 * jj + 2 * r;
              da[jj / 2][2 * (jj % 2) + r] =
                  pack_bf16x2(st[i] * (dpt[i] - dl.x),
                              st[i + 1] * (dpt[i + 1] - dl.y));
            }
          }
          // dV += P^T dO, dK += dS^T Q over the tile's 64 rows, 4 k16
          // steps: dO and Q are the B operand in their MN-major form
          wgmma_pin(dv);
          wgmma_pin(dk);
          wgmma_pin(pa);
          wgmma_pin(da);
          wgmma_fence();
#pragma unroll
          for (int kt4 = 0; kt4 < 4; ++kt4)
            wgmma_rs<NW>(dv, pa[kt4],
                         wgmma_desc(dob + nb + kt4 * 16 * 128, BQ * 128,
                                    1024));
#pragma unroll
          for (int kt4 = 0; kt4 < 4; ++kt4)
            wgmma_rs<NW>(dk, da[kt4],
                         wgmma_desc(qb + nb + kt4 * 16 * 128, BQ * 128,
                                    1024));
          wgmma_commit();
          wgmma_wait<0>();
          wgmma_pin(dv);
          wgmma_pin(dk);
        }
        mbar_arrive(empty + 8 * s);
      }
    }
    // every product with this K and V is done: the next may load
    mbar_arrive(kv_empty);
    const uint32_t so_wg = so + wg * T::O_BYTES;
    fab_store<NW>(dv, 1.f, so_wg, &tdv, n0, kvh, wk0, b, D, wg, tid);
    fab_store<NW>(dk, scale, so_wg, &tdk, n0, kvh, wk0, b, D, wg, tid);
  }
  // the staging buffers stay until the last stores have read them
  if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// dQ of BQ query rows of one (b, h), the forward's tiles and walk: query
// tiles in pairs (nq - 1 - i, i) (fa_next_tile), each over the key tiles
// from the window's lower edge to its causal frontier; for each, S = Q K^T
// and dP = dO V^T (SS), dS = P (dP - delta) (1 - t^2) in f32 registers,
// rounded to bf16 as the A fragment, then dQ += dS K (RS, K MN-major).
// lse and delta of the thread's two rows (from the rows kernel's tiles)
// stay in registers (a row past S: lse +inf, so P = 0 before the mask).
template <int DP, int DN, bool kWindow>
__global__ void __launch_bounds__(FabDq<DP>::THREADS, 1)
    flash_attention_bwd_wgmma_dq_kernel(
        const __grid_constant__ CUtensorMap tq,
        const __grid_constant__ CUtensorMap tk,
        const __grid_constant__ CUtensorMap tv,
        const __grid_constant__ CUtensorMap tdo,
        const __grid_constant__ CUtensorMap tdq,
        const float* __restrict__ rows, int B, int S, int H, int KVH, int D,
        float scale, float softcap, int window) {
  using T = FabDq<DP>;
  constexpr int BQ = T::BQ, BK = T::BK, ST = T::STAGES, NB = T::NB;
  extern __shared__ uint8_t fa_raw[];
  const uint32_t sq = (smem_u32(fa_raw) + 1023) & ~1023u;  // Q
  const uint32_t sdo = sq + T::Q_BYTES;                    // dO
  const uint32_t sk = sdo + T::Q_BYTES;                    // K ring
  const uint32_t sv = sk + ST * T::KV_BYTES;               // V ring
  const uint32_t so = sv + ST * T::KV_BYTES;               // staging [2]
  const uint32_t q_full = so + 2 * T::O_BYTES;
  const uint32_t q_empty = q_full + 8;
  const uint32_t kv_full = q_empty + 8;     // [ST]
  const uint32_t kv_empty = kv_full + 8 * ST;  // [ST]

  const int nq = (S + BQ - 1) / BQ;
  const int n_units = B * H * ((nq + 1) / 2);
  const int wg = threadIdx.x / 128;
  auto key_hi = [&](int qt) { return (min(qt * BQ + BQ, S) + BK - 1) / BK; };
  auto key_lo = [&](int qt) {
    return kWindow ? max(0, qt * BQ - window + 1) / BK : 0;
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 2 * 128);
    for (int s = 0; s < ST; ++s) {
      mbar_init(kv_full + 8 * s, 1);
      mbar_init(kv_empty + 8 * s, 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // producer: per query tile its first K/V tile, then Q and dO once the
    // consumers are done with the last ones, then the other K/V tiles
    regs_dealloc<24>();
    if (threadIdx.x != 256) return;
    auto load_kv = [&](int g, int t, int kvh, int b) {
      const int s = g % ST;
      if (g >= ST) mbar_wait(kv_empty + 8 * s, ((g / ST) - 1) & 1);
      mbar_expect_tx(kv_full + 8 * s, 2 * T::KV_BYTES);
      for (int c = 0; c < NB; ++c) {
        tma_load_4d(sk + s * T::KV_BYTES + c * BK * 128, &tk,
                    kv_full + 8 * s, 64 * c, kvh, t * BK, b);
        tma_load_4d(sv + s * T::KV_BYTES + c * BK * 128, &tv,
                    kv_full + 8 * s, 64 * c, kvh, t * BK, b);
      }
    };
    int items = 0, tiles = 0, b, h, qt;
    for (int j = 0; fa_next_tile(j, nq, n_units, H, b, h, qt); ++j) {
      const int kvh = h / (H / KVH), lo = key_lo(qt);
      const int n_tiles = key_hi(qt) - lo;
      load_kv(tiles, lo, kvh, b);
      if (items > 0) mbar_wait(q_empty, (items - 1) & 1);
      mbar_expect_tx(q_full, 2 * T::Q_BYTES);
      for (int c = 0; c < NB; ++c) {
        tma_load_4d(sq + c * BQ * 128, &tq, q_full, 64 * c, h, qt * BQ, b);
        tma_load_4d(sdo + c * BQ * 128, &tdo, q_full, 64 * c, h, qt * BQ,
                    b);
      }
      for (int t = 1; t < n_tiles; ++t) load_kv(tiles + t, lo + t, kvh, b);
      tiles += n_tiles;
      ++items;
    }
    return;
  }

  // consumers: warpgroup wg owns rows wq0 .. wq0 + 63 of a query tile; this
  // thread rows row0 and row0 + 8, at columns 8 j + c2 + {0, 1}
  regs_alloc<240>();
  const int tid = threadIdx.x % 128;
  const int c2 = 2 * (tid % 4);
  const int rr = 16 * (tid / 32) + (tid % 32) / 4;
  const uint32_t qa0 = sq + wg * 64 * 128, doa0 = sdo + wg * 64 * 128;
  const float c = scale * FA_LOG2E;
  const float to_cap = softcap > 0.f ? scale / softcap : 0.f;
  float dq[DN / 2];
  int items = 0, tiles = 0, b, h, qt;
  for (int j = 0; fa_next_tile(j, nq, n_units, H, b, h, qt); ++j, ++items) {
    const int wq0 = qt * BQ + 64 * wg, row0 = wq0 + rr;
    const int lo = key_lo(qt), n_tiles = key_hi(qt) - lo;
    float nl[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r, S64 = (S + 63) / 64 * 64;
      const float* at = rows + (static_cast<long long>(b) * H + h) * 2 * S64 +
                        128 * (row / 64) + row % 64;
      nl[r] = row < S ? -at[0] * FA_LOG2E : FA_MINUS_INF;
      dl[r] = row < S ? at[64] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < DN / 2; ++i) dq[i] = 0.f;
    mbar_wait(q_full, items & 1);
    for (int t = 0; t < n_tiles; ++t) {
      const int g = tiles + t, s = g % ST, k0 = (lo + t) * BK;
      mbar_wait(kv_full + 8 * s, (g / ST) & 1);
      const bool skip = wq0 >= S || k0 > wq0 + 63 ||
                        (kWindow && k0 + BK - 1 + window <= wq0);
      const uint32_t kb = sk + s * T::KV_BYTES, vb = sv + s * T::KV_BYTES;
      float sc[BK / 2], dp[BK / 2];
      if (!skip) {
        const uint32_t qa = opaque(qa0), doa = opaque(doa0);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DN / 16; ++kk) {
          const uint32_t o = (kk % 4) * 32;
          wgmma_ss<BK>(sc, wgmma_desc(qa + (kk / 4) * BQ * 128 + o, 16, 1024),
                       wgmma_desc(kb + (kk / 4) * BK * 128 + o, 16, 1024),
                       kk > 0);
        }
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < DN / 16; ++kk) {
          const uint32_t o = (kk % 4) * 32;
          wgmma_ss<BK>(dp,
                       wgmma_desc(doa + (kk / 4) * BQ * 128 + o, 16, 1024),
                       wgmma_desc(vb + (kk / 4) * BK * 128 + o, 16, 1024),
                       kk > 0);
        }
        wgmma_commit();
        const bool edge = k0 + BK - 1 > wq0 || wq0 + 64 > S ||
                          (kWindow && k0 + window <= wq0 + 63);
        wgmma_wait<1>();
        wgmma_pin(sc);
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const int r = (i / 2) % 2;
          float dc;
          float p = fab_prob(sc[i], nl[r], c, softcap, to_cap, dc);
          if (edge) {
            const int key = k0 + 8 * (i / 4) + c2 + (i % 2);
            const int row = row0 + 8 * r;
            if (key > row || row >= S || (kWindow && key + window <= row))
              p = 0.f;
          }
          sc[i] = p * dc;
        }
        wgmma_wait<0>();
        wgmma_pin(dp);
      }
      // the last products with Q and dO are done: the next may load
      if (t == n_tiles - 1) mbar_arrive(q_empty);
      if (!skip) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) sc[i] *= dp[i] - dl[(i / 2) % 2];
        uint32_t da[BK / 16][4];
        pack_p<BK>(da, sc);
        wgmma_pin(dq);
        wgmma_pin(da);
        wgmma_fence();
#pragma unroll
        for (int kt = 0; kt < BK / 16; ++kt)
          wgmma_rs<DN>(dq, da[kt],
                       wgmma_desc(kb + kt * 16 * 128, BK * 128, 1024));
        wgmma_commit();
        wgmma_wait<0>();
        wgmma_pin(dq);
      }
      mbar_arrive(kv_empty + 8 * s);
    }
    tiles += n_tiles;
    fab_store<DN>(dq, scale, so + wg * T::O_BYTES, &tdq, 0, h, wq0, b, D, wg,
                  tid);
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// one persistent kernel's launch: its shared memory, and a grid of one CTA
// per SM or one per unit of work, whichever is fewer
template <typename K, typename... Args>
static int launch_persistent(K kernel, int smem, long long units,
                             cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (units > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(units < sms ? units : sms);
  kernel<<<grid, 3 * 128, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// the bf16 backward: the rows' lse and delta in tiles (into `rows`, 2 B H
// S64 floats), then dK/dV, then dQ
template <int DP, int DN>
static int launch_fab_wgmma(const void* q, const void* k, const void* v,
                            const void* o, const float* lse,
                            const void* dout, void* dq, void* dk, void* dv,
                            float* rows, int B, int S, int H, int KVH,
                            int D, float softcap, int window,
                            cudaStream_t stream) {
  using TK = FabDkdv<DP>;
  using TQ = FabDq<DP>;
  if (B == 0 || S == 0) return 0;
  const EncodeTiledFn encode = tensor_map_encoder();
  if (encode == nullptr) return FA_NO_ENCODER;
  CUtensorMap mq, mdo, mk, mv, mdk, mdv, nq, ndo, nk, nv, mdq;
  int rc = encode_bhsd(encode, &mq, q, B, S, H, D, TK::BQ);
  if (rc == 0) rc = encode_bhsd(encode, &mdo, dout, B, S, H, D, TK::BQ);
  if (rc == 0) rc = encode_bhsd(encode, &mk, k, B, S, KVH, D, TK::BKV);
  if (rc == 0) rc = encode_bhsd(encode, &mv, v, B, S, KVH, D, TK::BKV);
  if (rc == 0) rc = encode_bhsd(encode, &mdk, dk, B, S, KVH, D, 64);
  if (rc == 0) rc = encode_bhsd(encode, &mdv, dv, B, S, KVH, D, 64);
  if (rc == 0) rc = encode_bhsd(encode, &nq, q, B, S, H, D, TQ::BQ);
  if (rc == 0) rc = encode_bhsd(encode, &ndo, dout, B, S, H, D, TQ::BQ);
  if (rc == 0) rc = encode_bhsd(encode, &nk, k, B, S, KVH, D, TQ::BK);
  if (rc == 0) rc = encode_bhsd(encode, &nv, v, B, S, KVH, D, TQ::BK);
  if (rc == 0) rc = encode_bhsd(encode, &mdq, dq, B, S, H, D, 64);
  if (rc != 0) return rc;
  const int S64 = (S + 63) / 64 * 64;
  const long long n = static_cast<long long>(B) * S64 * H;
  if ((n + 7) / 8 > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  flash_attention_bwd_rows_kernel<bf16>
      <<<static_cast<unsigned>((n + 7) / 8), 256, 0, stream>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), lse, rows,
      S, S64, H, D, n);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  // a window of S keys or more is no window: the causal instances
  const bool win = window > 0 && window < S;
  const long long kv_units = static_cast<long long>(B) * KVH *
                             (((S + TK::BKV - 1) / TK::BKV + 1) / 2);
  rc = launch_persistent(
      win ? flash_attention_bwd_wgmma_dkdv_kernel<DP, DN, true>
          : flash_attention_bwd_wgmma_dkdv_kernel<DP, DN, false>,
      TK::SMEM, kv_units, stream, mq, mk, mv, mdo, mdk, mdv,
      static_cast<const float*>(rows), B, S, H, KVH, D, scale, softcap,
      window);
  if (rc != 0) return rc;
  const long long q_units = static_cast<long long>(B) * H *
                            (((S + TQ::BQ - 1) / TQ::BQ + 1) / 2);
  return launch_persistent(
      win ? flash_attention_bwd_wgmma_dq_kernel<DP, DN, true>
          : flash_attention_bwd_wgmma_dq_kernel<DP, DN, false>,
      TQ::SMEM, q_units, stream, nq, nk, nv, ndo, mdq,
      static_cast<const float*>(rows), B, S, H, KVH, D, scale, softcap,
      window);
}

static int dispatch_fab_wgmma(const void* q, const void* k, const void* v,
                              const void* o, const float* lse,
                              const void* dout, void* dq, void* dk, void* dv,
                              float* rows, int B, int S, int H, int KVH,
                              int D, float softcap, int window,
                              cudaStream_t st) {
#define FAB_WGMMA(DP, DN)                                                  \
  return launch_fab_wgmma<DP, DN>(q, k, v, o, lse, dout, dq, dk, dv, rows,  \
                                  B, S, H, KVH, D, softcap, window, st)
  switch (D) {
    case 16:
    case 32:
    case 64: FAB_WGMMA(64, 64);
    case 96: FAB_WGMMA(128, 96);
    case 112: FAB_WGMMA(128, 112);
    case 128: FAB_WGMMA(128, 128);
    case 256: FAB_WGMMA(256, 256);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FAB_WGMMA
}

// ---------------------------------------------------------------------------
// K9 backward (no TPU counterpart, as K8's)
// ---------------------------------------------------------------------------

#define RNB_THREADS 256

// the sums of a CTA's 256 threads, two at once, in one fixed order
__device__ __forceinline__ float2 rnb_sum2(float a, float b) {
  __shared__ float part[2][RNB_THREADS / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
  if (threadIdx.x % 32 == 0) {
    part[0][threadIdx.x / 32] = a;
    part[1][threadIdx.x / 32] = b;
  }
  __syncthreads();
  float2 t = make_float2(0.f, 0.f);
#pragma unroll
  for (int w = 0; w < RNB_THREADS / 32; ++w) {
    t.x += part[0][w];
    t.y += part[1][w];
  }
  __syncthreads();  // the slots are free for the next row
  return t;
}

// rows [blockIdx.x rpc, +rpc) of (rows, d): per row, in f32, s = x (+ r),
// rstd = 1 / sqrt(mean(s^2) + eps), x^ = s rstd, gw = g (1 + w),
// dx = rstd (gw - x^ mean(gw x^)) (+ gs, the gradient of the returned sum
// in the residual form, the same for x and r); this CTA's sums of g x^ per
// column stay in shared memory (each thread its own columns) and leave as
// one row of `partial`, which rmsnorm_bwd_dw_kernel reduces in order
template <typename T, typename W, bool kResidual>
__global__ void __launch_bounds__(RNB_THREADS)
    rmsnorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ r,
                       const W* __restrict__ w, const T* __restrict__ g,
                       const T* __restrict__ gs, T* __restrict__ dx,
                       float* __restrict__ partial, long long rows, int d,
                       float eps, long long rpc) {
  extern __shared__ __align__(16) float rnb_acc[];
  const int c0 = 4 * threadIdx.x;
  for (int j = c0; j < d; j += 4 * RNB_THREADS)
    *reinterpret_cast<float4*>(rnb_acc + j) = make_float4(0.f, 0.f, 0.f, 0.f);
  const long long r0 = blockIdx.x * rpc;
  const long long r1 = min(rows, r0 + rpc);
  const float inv_d = 1.f / static_cast<float>(d);
  for (long long row = r0; row < r1; ++row) {
    const long long base = row * d;
    float ss = 0.f, sg = 0.f;
    for (int j = c0; j < d; j += 4 * RNB_THREADS) {
      float4 s = load4(x + base + j);
      if (kResidual) {
        const float4 b = load4(r + base + j);
        s = make_float4(s.x + b.x, s.y + b.y, s.z + b.z, s.w + b.w);
      }
      const float4 gg = load4(g + base + j), ww = load4(w + j);
      ss += s.x * s.x + s.y * s.y + s.z * s.z + s.w * s.w;
      sg += gg.x * (1.f + ww.x) * s.x + gg.y * (1.f + ww.y) * s.y +
            gg.z * (1.f + ww.z) * s.z + gg.w * (1.f + ww.w) * s.w;
    }
    const float2 t = rnb_sum2(ss, sg);
    const float rstd = rsqrtf(t.x * inv_d + eps);
    const float mgx = t.y * rstd * inv_d;  // mean(gw x^)
    for (int j = c0; j < d; j += 4 * RNB_THREADS) {
      float4 s = load4(x + base + j);
      if (kResidual) {
        const float4 b = load4(r + base + j);
        s = make_float4(s.x + b.x, s.y + b.y, s.z + b.z, s.w + b.w);
      }
      const float4 gg = load4(g + base + j), ww = load4(w + j);
      const float h[4] = {s.x * rstd, s.y * rstd, s.z * rstd, s.w * rstd};
      const float gv[4] = {gg.x, gg.y, gg.z, gg.w};
      const float wv[4] = {ww.x, ww.y, ww.z, ww.w};
      float o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        o[e] = rstd * (gv[e] * (1.f + wv[e]) - h[e] * mgx);
        rnb_acc[j + e] += gv[e] * h[e];
      }
      if (kResidual) {
        const float4 b = load4(gs + base + j);
        o[0] += b.x;
        o[1] += b.y;
        o[2] += b.z;
        o[3] += b.w;
      }
      store4(dx + base + j, make_float4(o[0], o[1], o[2], o[3]));
    }
  }
  for (int j = c0; j < d; j += 4 * RNB_THREADS)
    *reinterpret_cast<float4*>(partial + blockIdx.x * static_cast<long long>(d)
                               + j) =
        *reinterpret_cast<const float4*>(rnb_acc + j);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(bf16* p, float v) {
  p->bits = static_cast<uint16_t>(f32_to_bf16_bits(v));
}

// dw[j] = the sum of the CTAs' partial rows, in CTA order, 32 rows at a
// time summed apart (one sequential sum over ~1000 rows grows its error
// with their count)
template <typename W>
__global__ void __launch_bounds__(RNB_THREADS)
    rmsnorm_bwd_dw_kernel(const float* __restrict__ partial,
                          W* __restrict__ dw, int n_cta, int d) {
  const int j = blockIdx.x * RNB_THREADS + threadIdx.x;
  if (j >= d) return;
  float s = 0.f;
  for (int c0 = 0; c0 < n_cta; c0 += 32) {
    float t = 0.f;
    for (int c = c0; c < min(c0 + 32, n_cta); ++c)
      t += partial[static_cast<long long>(c) * d + j];
    s += t;
  }
  store1(dw + j, s);
}

template <typename T, typename W, bool kResidual>
static int launch_rn_bwd(const void* x, const void* r, const void* w,
                         const void* g, const void* gs, void* dx, void* dw,
                         float* partial, long long rows, int d, float eps,
                         int n_cta, cudaStream_t stream) {
  if (rows == 0 || d == 0) return 0;
  const long long rpc = (rows + n_cta - 1) / n_cta;
  const int ctas = static_cast<int>((rows + rpc - 1) / rpc);
  const int smem = d * 4;
  auto kernel = rmsnorm_bwd_kernel<T, W, kResidual>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<ctas, RNB_THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(r),
      static_cast<const W*>(w), static_cast<const T*>(g),
      static_cast<const T*>(gs), static_cast<T*>(dx), partial, rows, d, eps,
      rpc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rmsnorm_bwd_dw_kernel<W><<<(d + RNB_THREADS - 1) / RNB_THREADS, RNB_THREADS,
                             0, stream>>>(partial, static_cast<W*>(dw), ctas,
                                          d);
  return static_cast<int>(cudaGetLastError());
}

template <bool kResidual>
static int dispatch_rn_bwd(const void* x, const void* r, const void* w,
                           const void* g, const void* gs, void* dx, void* dw,
                           float* partial, int dtype, int w_dtype,
                           long long rows, int d, float eps, int n_cta,
                           cudaStream_t st) {
  if (d % 4 || n_cta < 1 || d * 4 > 227 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == DT_F32 && w_dtype == DT_F32)
    return launch_rn_bwd<float, float, kResidual>(x, r, w, g, gs, dx, dw,
                                                  partial, rows, d, eps,
                                                  n_cta, st);
  if (dtype == DT_BF16 && w_dtype == DT_F32)
    return launch_rn_bwd<bf16, float, kResidual>(x, r, w, g, gs, dx, dw,
                                                 partial, rows, d, eps,
                                                 n_cta, st);
  if (dtype == DT_F32 && w_dtype == DT_BF16)
    return launch_rn_bwd<float, bf16, kResidual>(x, r, w, g, gs, dx, dw,
                                                 partial, rows, d, eps,
                                                 n_cta, st);
  if (dtype == DT_BF16 && w_dtype == DT_BF16)
    return launch_rn_bwd<bf16, bf16, kResidual>(x, r, w, g, gs, dx, dw,
                                                partial, rows, d, eps, n_cta,
                                                st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" {

// q (B, S, H, D), k/v (B, S, KVH, D), o like q; contiguous, 16-byte
// aligned, D in {16, 32, 64, 96, 112, 128, 256}, H % KVH == 0; window 0
// (none) or the keys k > q - window of each query q; lse (B, H, S) f32,
// the rows' log-sum-exp for the backward, or null (serving).
// float32 runs flash_attention_fwd_kernel, bfloat16
// flash_attention_wgmma_kernel.
int launch_flash_attention(const void* q, const void* k, const void* v,
                           void* o, void* lse, int dtype, int B, int S,
                           int H, int KVH, int D, float softcap, int window,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (window < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == DT_F32)
    return dispatch_fa_f32(q, k, v, o, l, B, S, H, KVH, D, softcap, window,
                           st);
  if (dtype == DT_BF16)
    return dispatch_fa_wgmma(q, k, v, o, l, B, S, H, KVH, D, softcap,
                             window, st);
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

// the K10 backward: g, out, ds (nc, B, H, N, P) and decay, dd (nc, B, H),
// f32 and contiguous; bh = B*H, np = N*P; one CTA per (b, h)
int launch_ssm_state_scan_bwd(const void* g, const void* out,
                              const void* decay, void* ds, void* dd, int nc,
                              long long bh, int np, void* stream) {
  if (nc == 0 || bh == 0) return 0;
  if (np <= 0 || bh > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec =
      np % 4 == 0 && ((reinterpret_cast<uintptr_t>(g) |
                       reinterpret_cast<uintptr_t>(out) |
                       reinterpret_cast<uintptr_t>(ds)) & 15) == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* gp = static_cast<const float*>(g);
  const float* op = static_cast<const float*>(out);
  const float* dp = static_cast<const float*>(decay);
  if (vec)
    ssm_state_scan_bwd_kernel<true>
        <<<static_cast<unsigned>(bh), SCAN_BWD_THREADS, 0, st>>>(
            gp, op, dp, static_cast<float*>(ds), static_cast<float*>(dd), nc,
            bh, np);
  else
    ssm_state_scan_bwd_kernel<false>
        <<<static_cast<unsigned>(bh), SCAN_BWD_THREADS, 0, st>>>(
            gp, op, dp, static_cast<float*>(ds), static_cast<float*>(dd), nc,
            bh, np);
  return static_cast<int>(cudaGetLastError());
}

// the K8 backward: q, dq (B, S, H, D), k, v, dk, dv (B, S, KVH, D), o and
// dout like q, lse (B, H, S) f32 from the forward, delta f32 scratch of
// 2 B H S64 values, S64 = S rounded up to 64 (each 64-row tile's lse and
// delta side by side); the forward's shapes, window and softcap.  Three
// launches: flash_attention_bwd_rows_kernel (delta = rowsum(dO O)), dK/dV,
// dQ; the dtype picks the last two, all on the tensor cores: float32
// flash_attention_bwd_tf32_{dkdv,dq}_kernel (3xTF32), bfloat16
// flash_attention_bwd_wgmma_{dkdv,dq}_kernel.
int launch_flash_attention_bwd(const void* q, const void* k, const void* v,
                               const void* o, const void* lse,
                               const void* dout, void* dq, void* dk, void* dv,
                               void* delta, int dtype, int B, int S, int H,
                               int KVH, int D, float softcap, int window,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (window < 0 || H % KVH) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == DT_F32)
    return dispatch_fb_tf32(q, k, v, o, l, dout, dq, dk, dv, dl, B, S, H,
                            KVH, D, softcap, window, st);
  if (dtype == DT_BF16)
    return dispatch_fab_wgmma(q, k, v, o, l, dout, dq, dk, dv, dl, B, S, H,
                              KVH, D, softcap, window, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// the K9 backward: x, g, dx (rows, d), w and dw (d,), partial (n_cta, d)
// f32 scratch; r and gs (the residual and the gradient of the returned
// sum) null for the plain norm
int launch_rmsnorm_bwd(const void* x, const void* r, const void* w,
                       const void* g, const void* gs, void* dx, void* dw,
                       void* partial, int dtype, int w_dtype, long long rows,
                       int d, float eps, int n_cta, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  if (r == nullptr)
    return dispatch_rn_bwd<false>(x, r, w, g, gs, dx, dw, p, dtype, w_dtype,
                                  rows, d, eps, n_cta, st);
  return dispatch_rn_bwd<true>(x, r, w, g, gs, dx, dw, p, dtype, w_dtype,
                               rows, d, eps, n_cta, st);
}

const char* lm_error_string(int code) {
  if (code == FA_NO_ENCODER)
    return "cuTensorMapEncodeTiled is not available from the driver";
  if (code == FA_ENCODE_FAILED)
    return "cuTensorMapEncodeTiled refused a K8 tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
