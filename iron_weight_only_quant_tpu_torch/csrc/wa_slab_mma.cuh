// A16 and A8 dequant-matmul on Hopper's int8 tensor cores (sm_90a):
//   y[M,N] = sx[M] * ((256*hi + lo)[M,K] @ dequant(qw)[K,N]),
// split-plane 16-bit activations against 4-bit (nib4), 8-bit (byte) or
// 3-bit (s21) affine codes, or 4-bit (nib4) or 6-bit (nq42) minifloat codes
// decoded to their exact int8 grid; with one plane (A8, PLANES = 1), y =
// sx * (q @ dequant(qw)) on the affine layouts; and its bf16 family (below)
// on the bf16 tensor cores,
//   y[M,N] = x[M,K] @ dequant(qw)[K,N]  (times r[M] for the W4 and W8
// prenorm forms), bf16 x, the nib4, nq42 and byte LUT layouts and the s21,
// nib4 and byte affine ones, codes decoded to their exact bf16 values.
//
// Replaces the Pallas TPU kernels in
// iron_weight_only_quant_tpu/ops/pallas/dequant_matmul.py:
//   _int4_kernel_a16 (:418, called at :1670) and its stacked form
//       _int4_kernel_a16_pfx (:1722, through :1927);
//   _int8_kernel_a16 (:449, called at :1691) and its stacked form
//       _int8_kernel_a16_pfx (:1727, through :1927);
//   _int3_kernel_a16 (:533) and its stacked form _int3_kernel_a16_pfx (:588),
//       both through _call_int3 (:1365);
//   _lut4_kernel_a16 (:771, called at :1607) and its stacked form
//       _lut4_kernel_a16_pfx (:806, through :1927);
//   _lut6_kernel_a16 (:892) and its stacked form _lut6_kernel_a16_pfx (:934),
//       both through _call_lut6 (:939);
//   one plane, the int path of _group_accum (:226-249) with int8 x:
//       _int4_kernel (:319, body :293), called at :1680, and its stacked form
//       _int4_kernel_pfx (:1712, through :1927); _int8_kernel (:1057, body
//       _int8_body :1040), called at :1700, and its stacked form
//       _int8_kernel_pfx (:1717, through :1927); _int3_kernel (:467) and its
//       stacked form _int3_kernel_pfx (:1360), both through _call_int3
//       (:1365) from :1572 and :1794.
// All reduce to _group_accum_a16 (:253-286), _lut_accum_a16 (:698) and the
// int path of _group_accum: per group and plane an int32 product turned
// f32, part = 256*pa + pb (A8: part = pa, xsum = sum(q)), then
//   affine (nib4, byte, s21): acc += part*(s*mult) - xsum*(s*(z - zshift)),
//   LUT (nib4, nq42):         acc += part*(s*2^-t) [+ xsum*z where the artifact has zeros],
// with xsum = 256*sum(hi) + sum(lo) over the group's activations; mult = 1,
// zshift = 0, but for the affine nib4 high slab, whose codes are the JAX
// kernel's w & 0xF0 read as int8, 16 q - 128: mult = 1/16, zshift = 8.  The
// stacked forms are the same kernels: the wrapper offsets the weight and
// side-info base pointers by the layer.
//
// Layouts (ops/packing.py; see w8_common.cuh, w3_common.cuh and
// lut_common.cuh): every layout is read as S slabs of Kb packed rows, row r
// of slab i holding K column i*Kb + r.  byte: qw [Kb = K, N], S = 1, the
// stored byte read as int8 is the code (the JAX bitcast to int8; zeros are
// stored shifted alike); nib4 (affine and LUT): qw [Kb = K/2, N], S = 2,
// the low nibble, then the MSB-flipped high nibble; s21: qw [3 Kb, N], S = 8 slabs of Kb = K/8
// rows (A rows (i % 2)*Kb + r, field i / 2, plus bit i of B row 2 Kb + r);
// nq42: qw [3 Kb, N], S = 4 quarters of Kb = K/4 rows (nibble row (i % 2)*Kb
// + r, low nibble for i < 2, flipped high nibble for i >= 2, plus bits
// 2i..2i+1 of quad row 2 Kb + r).  The wrapper guarantees G | Kb and G % 4
// == 0, Kb % 4 == 0; neither needs to be a multiple of 32.
//
// Two or three kernels per call, on one stream:
//  1. quantize_rows_slab_kernel, one 1024-thread block per activation row:
//     the activation codes (the JAX _prep_x :1270-1316, which quantized
//     them in XLA: A8 sx = max(max|x|, 1e-8) / 127, q = clip(rint(x / sx),
//     +-127); A16 sx = max(max|x|, 1e-8) / 32512, xi = rint(x / sx), hi =
//     (xi + 128) >> 8, lo = xi - (hi << 8); IEEE division and rintf, round
//     half to even as jnp.round, so bit-equal to the plain
//     quantize_activations; optionally after the weightless RMSNorm, x * 1 /
//     sqrt(mean(x^2) + eps) over the real columns cast back to x's type, as
//     fused_quantized_matmul applies a pre-norm under activation bits at
//     :1518-1522; its sum of squares and the row's absmax come from one
//     pass), written per
//     slab with each slab padded to Kb32 = Kb rounded up to 32 rows
//     ([2][M][S][Kb32], A8 [1][M][S][Kb32], zero beyond Kb and beyond the
//     logical K); one warp quantizes a group and sums its codes by
//     shuffles into xsum[M][S*Kb/G] (256*hi + lo, A8 the sum of q, groups
//     in K order: the JAX xsum as integers).  A LUT
//     artifact without zero points skips the sums, and the product kernel
//     never reads them.
//  2. wa_slab_mma_kernel: the products on the tensor cores,
//     mma.sync.m16n8k32.s32.s8.s8.s32 with the operands swapped: the weight
//     is the 16-row A operand (16 output channels by 32 K), the tokens the
//     8-column B operand.  A block of eight warps takes BN channels, MT =
//     8 * NT tokens and a K-split range of kc slab rows, which it splits into
//     P parts of kq = kc / P rows, each a multiple of the 32-row window.  A
//     warp takes SW slabs of one part (a group) and a channel part: warp w
//     takes group v = w % V, V = S / SW * P, i.e. slabs SW * (v % (S / SW))
//     on and part v / (S / SW), and channel part w / V.  s21: one warp a
//     slab (P = 1); nq42: two warps a quarter (P = 1); byte: P = 4, two
//     warps a part; nib4: P = 2, at decode four warps take both slabs of a
//     part (SW = 2: one load and one transpose of a packed byte serve its
//     two codes), in the wider tiles two warps a slab.  All warps walk the
//     windows of their part in step.  Decode (NT = 1): BN = 64 (s21) or
//     128, two blocks an SM, so that one block's barrier stalls only its
//     own warps; more rows: NT = 2 (s21; with one plane 4) or 4 (affine
//     nib4 and byte with one plane: 8), BN = 64, one block an SM, so
//     a weight window is decoded ceil(M / MT) times, not M / 8.  A ring of 4
//     stages in shared memory takes each window by cp.async: 32 rows of the
//     block's columns of each packed array (s21, nq42: three) or each part
//     (byte, nib4: one array), in 16-byte copies (4-byte ones when N or the
//     base is not 16-byte aligned; zero-filled at and beyond the range's end
//     and N), and the x planes of every (slab, part) for the block's tokens.
//     At decode the 3 windows ahead hold 18 KB (s21), 36 KB (nq42), 24 KB
//     (nib4) or 48 KB (byte) of weight rows in flight a block, twice that
//     an SM.
//     Lane (g, t) = (lane / 4, lane % 4) takes CT MMA tiles of 16 channels
//     and reads its W = CT / 2 words (4 W channels) of rows 8t..8t+7 of its
//     part's window; the stage stores row 8t + i at position 4i + t and pads
//     each row to BN / 4 + 8 words, so every such load is conflict-free.
//     Per row word it decodes the four codes (byte: none; affine nib4 wide
//     tiles: one mask, 0x0F0F0F0F for the low slab, 0xF0F0F0F0 for the
//     high one, whose int8 codes are then 16 q - 128; LUT nib4 wide tiles: a
//     shift, a mask and the flip, then lut4_grid, two prmt lookups in an
//     eight-byte table and a sign select; s21: slab_codes, one shift, one
//     funnel rotate, two LOP3; nq42: then nq42_grid, arithmetic on the
//     exponent and mantissa fields), and a 4x4 byte transpose of rows
//     8t..8t+3 and 8t+4..8t+7 gives per channel the two words of four
//     K-consecutive codes that the A fragment wants (the nib4 decode tiles
//     transpose the packed bytes first and decode both slabs' codes of each
//     such word at once: two masks for 8 affine codes, lut4_grid2's 14
//     operations for 8 LUT ones):
//     channel 2c (2c + 1) of the lane is MMA row g (g + 8) of
//     tile c, MMA K slots 4t..4t+3 and 16+4t..16+4t+3 are rows 8t..8t+7.
//     The B fragment (token g, the same K order) is one conflict-free 64-bit
//     shared load of the staged x, whose rows stay in order.  So channels
//     are permuted inside a tile (undone in the epilogue by the same map)
//     and the K order is the same on both operands.
//     Every MMA's 32 K lie in one group of one slab: a window splits into
//     segments at group ends (main path: one segment, G = 128 is four
//     windows), and a segment of fewer than 32 rows zeroes the B registers
//     outside it (rows come in fours).  Each plane has its own s32
//     accumulator per group; at the group's end (or the part's) both turn
//     f32 and the epilogue above runs, the xsum term only in the warp whose
//     part holds the group's first row (a K-split or a part may cut a
//     group).  Scales, zeros (16-byte loads where the side rows are
//     contiguous) and sums are fetched when the window starts in which the
//     segment ends (the affine nib4 high slab's mult and zshift folded into
//     them).  Overflow: 128 * 128 * G per plane (< 2^31).  The warps'
//     f32 partials meet in shared memory and are summed over the groups in
//     a fixed order; with one split (prefill, and the wide
//     decode shapes) the block writes out = cast(sx * sum) itself, else its
//     partial to ws [splits, M, N].
//  3. with a K-split, the W4 reduce (w4_reduce_kernel with the row factor):
//     the fixed-order K-split sum, times sx, cast to x's type.
// Kernels 2 and 3 are launched programmatically (Hopper's dependent launch):
// the product kernel starts while the row pass runs, copies its first
// windows' weights, and waits for the row pass's output only before it
// copies x; the reduce starts as the product kernel's blocks finish.
//
// What bounds it: at decode (M = 8) the bytes: codes (1, 3/8, 1/2 or 3/4
// byte a weight) + f32 sides + two int8 planes of x (A8: one) + output over
// 3.35 TB/s; at prefill the 2 * 2*M*K*N int8 operations (A8: 2*M*K*N) over
// 1,979 TOP/s.  One plane halves the staged x, the B fragments, the s32
// accumulators and the MMAs of a window.  The design runs one m16n8k32 per
// 512 codes and plane, takes the activation sums out of the loop (once per
// row and group, in the row pass), and keeps the weight bytes in flight by
// asynchronous copies.  What
// limits it is instruction issue in the decode (nq42 most: about 20 integer
// operations a word of four codes) and, on small shapes, the fixed cost of
// two or three kernels a call.
//
// The bf16 family (LAYOUT kLut4B, kLut6B, kS21B, kNib4B, kByteB, kLut8B:
// the bf16-x calls of lut4_matmul, lut6_matmul, w3_matmul, w4_matmul and
// w4_matmul_prenorm, w8_matmul and w8_matmul_prenorm, and lut8_matmul).
// Replaces _lut4_kernel (:739, pfx :1732), _lut6_kernel (:835, pfx :887,
// through _call_lut6 :939), _lut8_kernel (:811, pfx :1737), _int3_kernel
// with bf16 x (:467, pfx :1360, through _call_int3 :1365), _int4_kernel
// (:319, body :293, pfx :1712) and _int4_kernel_prenorm (:328, pfx :408)
// with bf16 x, and _int8_kernel (:1057, body :1040, pfx :1717) and
// _int8_kernel_prenorm (:380, pfx :413) with bf16 x: per group acc += (x_g
// @ val_g) * s (+ xsum_g * z),
// _lut_accum (:724), with val the exact minifloat value in x's dtype, or acc
// += (x_g @ q_g) * s - xsum_g * (s * z), _group_accum (:226) over the twelve
// masked s21 fields (their powers of two folded into the epilogue), the two
// nib4 slabs or the byte codes (the stored byte read as int8, zeros stored
// shifted alike), contracted on the MXU with f32 sums; the prenorm form then
// scales the f32 sum by r = rsqrt(sum(x^2) / K_logical + eps) of the raw x
// (:374).  Every fp4, fp6 and byte minifloat value (1 + E + M <= 8 bits:
// at most 6 mantissa bits) and every 3-bit, 4-bit and signed 8-bit code is
// exact in bf16, so a bf16 mma.sync m16n8k16 with f32 accumulation computes
// those products; the
// kernel is the pipeline above (the same ring, windows split at group ends,
// parts, split plan, epilogue per group, dependent launches) with these
// differences:
//  - x stays bf16: the stage holds [part][slab][token][32 rows] of it, read
//    by cp.async straight from x [M, S*Kb] (slab i's row r at column i*Kb +
//    r, zero-filled beyond Kb), or from the copy a row pass made;
//  - a row pass (rows_bf16_slab_kernel) runs only where the call needs one:
//    with a pre-norm on the LUT and s21 layouts (lut8's qkv and gate_up on
//    the fp8 main path), to apply the weightless
//    RMSNorm (f32 mean of squares, x*r rounded to bf16: the function of
//    normalize-then-kernel, as the JAX package computes it for layouts
//    without a prenorm kernel) into a copy of x, and where x is not
//    16-byte aligned (a raw copy).  A call without a pre-norm is one
//    kernel, or two with a K-split;
//  - the W4 and W8 prenorm forms (template flag NORM; kNib4B, kByteB) keep
//    _int4_kernel_prenorm's and _int8_kernel_prenorm's function: no copy,
//    no normalized x.  The product kernel reads the raw
//    x, and beside each segment's sums of x (below) each lane of the warps
//    of channel part 0 (a warp-uniform branch: the other warps stage the
//    same rows) sums the squares of the same staged values for its token;
//    at the end those warps give their groups' sums to shared memory.
//    With one split the block scales each output by r = 1/sqrt(sum /
//    K_logical + eps) before the cast, in its own epilogue; with a K-split
//    the blocks of channel tile 0 write their split's sums to [splits, M]
//    after the partials, and the reduce (w4_reduce_kernel with SQ) sums
//    them in split order and finishes r.  So the prenorm call adds no
//    kernel: one with one split, two with a K-split;
//  - with zeros (template flag BZ; always for the affine layouts), each
//    warp sums the staged x of each segment it multiplies (f32, its B
//    registers, two shuffles over the K lanes, two to bring the D columns'
//    tokens), so every part adds the xsum * z term of its own rows, and no
//    pass sums x beforehand (a development A/B: faster than the row pass's
//    sums, and the same code freed the symmetric wide tile of its spills);
//  - the decode: a lane still reads rows 8t..8t+7 of its channels and
//    transposes them to per-channel words of four K-consecutive codes; each
//    such word becomes two bf16 pairs, the A fragment of m16n8k16 q (rows
//    8t+4q..8t+4q+3 in K slots 2t, 2t+1, 2t+8, 2t+9; B, one 16-byte load
//    of the staged x, in the same order).  LUT values come from the
//    format's widths, never from the codebook: codes_bf16 assembles value *
//    2^(bias-127) bytewise (the exponent field on bf16's, subnormals on its
//    subnormals) and multiplies by 2^(127-bias) (exact); the byte LUT
//    layout (kLut8B) first XORs the stored bytes with 0x80 (code - 128 back
//    to the code: one LOP3 a word); the nib4 decode
//    tile takes both slabs of a packed byte at once (lut4_bf16x2: prmt
//    lookups of a table of the eight magnitudes' bf16 bytes, built from the
//    widths, and prmt's sign mode).  Integer codes below 128 (s21's
//    slab_codes, as the int8 family; affine nib4's) become bf16 by
//    int_codes_bf16: two prmt under the exponent byte of 128 and two bf16x2
//    fma subtracting 128.  Affine nib4 (kNib4B) undoes the high nibble's
//    MSB flip in the decode (nib4_bf16x2 at the decode tile, both slabs of
//    a word: one mask gives the low codes, one shift and one LOP3 of mask
//    and flip the logical high codes q; the wide tile: nib4_codes before
//    the transpose), so both slabs share one epilogue with mult 1 and
//    zshift 0.  The JAX algebra's high codes 16 q - 128 (the int8 family's
//    kNib4) would need a byte of up to 240 under the exponent, whose top
//    bit lands in bf16's exponent: not a mantissa trick, and the flip costs
//    nothing once the mask is a LOP3.  The signed byte codes (kByteB) take
//    byte_codes_bf16: the low seven bits under the exponent byte of 128
//    (128 + b & 127) plus, in one bf16x2 fma, the sign bit under 0xC3 (-128
//    or -256), two LOP3, four PRMT and two HFMA2 a word of four codes
//    (b ^ 0x80, 0..255, under the exponent of 128 would put its top bit in
//    bf16's exponent, as above);
//  - each group's f32 MMA sum is the part; acc += part * s (+ xsum * z;
//    the affine layouts: - xsum * (s * z));
//  - tiles: the decode tile (M <= 8) is its packed layout's (nib4, LUT and
//    affine: two slabs a warp, P = 2; nq42: one, P = 1, BN = 128; s21: one,
//    P = 1, BN = 64; byte, affine and LUT: P = 4, two warps a part, BN =
//    128; two blocks an SM); beyond, one block an SM, the warps of a slab
//    each their own channels, P = 1: NT = 8 (64 tokens a block), two
//    channel tiles a warp (BN = 128 nib4, 64 nq42, 256 byte: eight warps on
//    its one slab); s21, one warp a slab: NT = 4 (32 tokens), four channel
//    tiles a warp (BN = 64), within the registers a thread has.  Each
//    weight is decoded once a block,
//    straight into the A fragments of the block's token tiles, so no shared
//    decoded tile (nor ldmatrix) is needed.  Bound: at decode the bytes
//    (codes + f32 sides + bf16 x + output) over 3.35 TB/s; at prefill
//    2*M*K*N over 989 TFLOP/s.
//
// The W4 inner-loop probe's two decodes (iwoq_w4_inner_matmul_mma in
// w4_inner_matmul.cu; the TPU probe _kernel_variant of
// scripts/probe_w4_inner.py, modes "magic" and "f32") are two more layouts
// of the affine nib4 packing, kNib4B's tiles, ring, split plan and reduce,
// each changing only the decode and the sides of its epilogue:
//  - kNib4M (magic): nib4_bf16x2 / nib4_codes without the bf16x2 fma that
//    subtracts 128: each code under the exponent byte 0x43 is bf16(128 +
//    q) exactly and becomes the A fragment; the epilogue folds the 128 into
//    the zero point, zc = -(s * (z + 128)), on both slabs (the JAX mode's
//    zshift -128).  The cancellation costs about 7 bits of each group's f32
//    sum (128 = 2^7 over codes of 0..15), against the 24 that an f32 bias
//    of 2^23 would cost (w4_inner_matmul.cu);
//  - kNib4T (f32): the codes converted to f32 by an int -> float convert,
//    the low ones q and the high ones (int8)(byte & 0xF0) = 16 (q - 8), the
//    staged bf16 x widened to f32 by a 16-bit shift, and the products on
//    the TF32 tensor cores, mma.sync m16n8k8 (A 16 x 8: four f32 registers
//    a lane, B 8 x 8: two).  No transpose: step k of a window takes rows
//    8t+2k (K slot t) and 8t+2k+1 (slot t + 4) of lane t, so each staged
//    word gives four channels' A registers of one row, decoded inside the
//    segment, a step at a time (a window's A fragments at once would need
//    twice kNib4B's registers).  The epilogue keeps the JAX mode's mult and
//    zshift per slab: the low slab s and -(s * z), the high slab s / 16 and
//    -(s * (z - 8)).  Exact: bf16 x has 8 significant bits, a code at most
//    8, and TF32 keeps 11, so each product is the mode's f32 product; the
//    TF32 rate (495 TFLOP/s) is half the bf16 one.
#pragma once

#include "lut_common.cuh"
#include "slab_tile.cuh"

namespace iwoq {

// v in x's type: unchanged for f32, rounded to nearest even for bf16.
__device__ __forceinline__ float round_to(float v, float) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Four packed rows w[0..3] of four byte columns -> four words, word j
// holding column j's bytes of rows 0..3 (byte i = row i).
__device__ __forceinline__ void transpose4x4(const uint32_t (&w)[4], uint32_t (&c)[4]) {
  const uint32_t a_lo = __byte_perm(w[0], w[1], 0x5140);  // w0.b0 w1.b0 w0.b1 w1.b1
  const uint32_t a_hi = __byte_perm(w[0], w[1], 0x7362);  // w0.b2 w1.b2 w0.b3 w1.b3
  const uint32_t b_lo = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t b_hi = __byte_perm(w[2], w[3], 0x7362);
  c[0] = __byte_perm(a_lo, b_lo, 0x5410);
  c[1] = __byte_perm(a_lo, b_lo, 0x7632);
  c[2] = __byte_perm(a_hi, b_hi, 0x5410);
  c[3] = __byte_perm(a_hi, b_hi, 0x7632);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 16 (or 4) bytes, zero-filling what lies beyond `bytes`.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Programmatic dependent launch: a kernel launched with
// cudaLaunchAttributeProgrammaticStreamSerialization may start once every
// block of the kernel before it has called griddep_launch_dependents (or
// ended); griddep_wait then waits for that kernel's end and its writes.
__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// d += a (16 x 32, row) * b (32 x 8, col), int8 in, int32 sums.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 0xFF in each byte whose bit 7 is set, 0x00 elsewhere (prmt's sign mode).
__device__ __forceinline__ uint32_t byte_sign_mask(uint32_t v) {
  uint32_t r;
  asm("prmt.b32 %0, %1, 0, 0xBA98;\n" : "=r"(r) : "r"(v));
  return r;
}

// The four codes of slab (or quarter) i in a packed row (bytes = columns)
// from its A (nibble) word a and B (quad) word b: ((a >> ash) & am) ^ flip
// | (rotr(b, brot) & bm), the shifts and masks of slab_fields.  s21: field
// i / 2 of a (field 3 un-flipped) plus 4 * bit i of b; nq42: the low nibble
// (i < 2) or the flipped high nibble of a plus 16 * bits 2i..2i+1 of b.
struct SlabFields {
  int ash, brot;
  uint32_t flip;
};
template <bool LUT>
__device__ __forceinline__ SlabFields slab_fields(int i) {
  if (LUT) return {i < 2 ? 0 : 4, (2 * i + 28) & 31, i < 2 ? 0u : 0x08080808u};
  return {2 * (i >> 1), (i + 30) & 31, (i >> 1) == 3 ? 0x02020202u : 0u};
}
template <bool LUT>
__device__ __forceinline__ uint32_t slab_codes(uint32_t a, uint32_t b, SlabFields f) {
  constexpr uint32_t am = LUT ? 0x0F0F0F0Fu : 0x03030303u, bm = LUT ? 0x30303030u : 0x04040404u;
  return (((a >> f.ash) & am) ^ f.flip) | (__funnelshift_r(b, b, f.brot) & bm);
}

// Four 6-bit minifloat codes (one a byte: sign bit 5, E exponent bits, M
// mantissa bits, E + M = 5) -> their int8 grid bytes, +-(mant_full <<
// (max(e, 1) - 1)) as _minifloat_int.  E = 1 (wide = 0): the magnitude is
// the low five bits.  E = 2 (wide = ~0): with m5 the low five bits, e = 2
// adds m5 & 15 (= m5 - 16) and e = 3 also 2 * (m5 & 7) (= 2 m5 - 48), so
// the magnitude is m5, 2 m5 - 16 or 4 m5 - 64.  No byte exceeds 60, so the
// word sums never carry; the negation 0x80 - v (no borrow) ^ 0x80 maps 0 to 0.
__device__ __forceinline__ uint32_t nq42_grid(uint32_t c, uint32_t wide) {
  const uint32_t e_hi = byte_sign_mask(c << 3) & wide;    // exponent bit 1 (E = 2)
  const uint32_t e_3 = byte_sign_mask(c << 4) & e_hi;     // exponent 3
  const uint32_t v = (c & 0x1F1F1F1Fu) + (c & e_hi & 0x0F0F0F0Fu) +
                     ((c << 1) & e_3 & 0x0E0E0E0Eu);
  const uint32_t neg = (0x80808080u - v) ^ 0x80808080u;
  const uint32_t sgn = byte_sign_mask(c << 2);
  return (v & ~sgn) | (neg & sgn);
}

// Stream i's four codes of a nib4 word (bytes = columns): the low nibble
// (i = 0) or the MSB-flipped high nibble (i = 1), as the logical code.
__device__ __forceinline__ uint32_t nib4_codes(uint32_t a, int i) {
  return ((a >> (4 * i)) & 0x0F0F0F0Fu) ^ (i ? 0x08080808u : 0u);
}

// Four 4-bit minifloat codes (one a byte: sign bit 3, magnitude bits 0..2)
// -> their int8 grid bytes.  tab holds the grid bytes of codes 0..7 (words
// 0, 1) and their negations (words 2, 3); the four magnitudes, packed into
// the nibbles of a prmt selector, look up both, and the sign picks one.
__device__ __forceinline__ uint32_t lut4_grid(uint32_t c, const uint32_t (&tab)[4]) {
  const uint32_t m = c & 0x07070707u;
  const uint32_t sel = __byte_perm(m | (m >> 4), 0, 0x0020);  // nibbles m0, m1, m2, m3
  const uint32_t sgn = byte_sign_mask(c << 4);
  return (__byte_perm(tab[0], tab[1], sel) & ~sgn) | (__byte_perm(tab[2], tab[3], sel) & sgn);
}

// prmt in its generic mode: byte n of the result is byte (nibble n of sel)
// & 7 of b:a, or, where the nibble's bit 3 is set, that byte's sign bit
// replicated.
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(r) : "r"(a), "r"(b), "r"(sel));
  return r;
}

// The eight 4-bit minifloat codes of a nib4 word w (bytes: four packed rows
// of one channel, each the low nibble's code of slab 0 and the MSB-flipped
// high nibble's of slab 1) -> their int8 grid bytes, slab 0's in lo and
// slab 1's in hi, in row order.  The magnitudes (bits 0..2 of each nibble)
// are prmt selectors as they lie, four nibbles (two rows) a lookup in tab
// (grid bytes of codes 0..7, then their negations); the signs (bit 3 of
// each nibble, unflipped) pick one, spread to bytes by prmt's sign mode.
__device__ __forceinline__ void lut4_grid2(uint32_t w, const uint32_t (&tab)[4], uint32_t& lo,
                                           uint32_t& hi) {
  const uint32_t m = w & 0x77777777u;
  const uint32_t t = w ^ 0x80808080u;  // slab 1's sign bits unflipped
  const uint32_t t4 = t << 4;          // slab 0's sign bits at bit 7 of each byte
  uint32_t v[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // rows 2h, 2h + 1: nibbles lo, hi, lo, hi
    const uint32_t sel = h ? m >> 16 : m;
    const uint32_t sgn = prmt(t4, t, h ? 0xFBEAu : 0xD9C8u);
    v[h] = (__byte_perm(tab[0], tab[1], sel) & ~sgn) | (__byte_perm(tab[2], tab[3], sel) & sgn);
  }
  lo = __byte_perm(v[0], v[1], 0x6420);
  hi = __byte_perm(v[0], v[1], 0x7531);
}

template <int W>
__device__ __forceinline__ void lds_words(const uint32_t* p, uint32_t (&w)[W]) {
  if constexpr (W == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x; w[1] = v.y;
  } else {
    w[0] = *p;
  }
}

// ---- the bf16 family: minifloat codes to their exact bf16 values

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a * b + c of two bf16 pairs, rounded once.
__device__ __forceinline__ uint32_t bf16x2_fma(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}

// a * b of two bf16 pairs (an fma with -0, which keeps every product, -0
// and subnormal inputs included, exact where it is representable).
__device__ __forceinline__ uint32_t bf16x2_mul(uint32_t a, uint32_t b) {
  return bf16x2_fma(a, b, 0x80008000u);
}

// Four integer codes q < 128 (bytes of c, in K order) -> the bf16 values of
// 128 + q, pairs (0, 1) and (2, 3): a byte q under the high byte 0x43 is
// the bf16 of 128 + q (the exponent of 128 and q in the mantissa), exactly.
// The probe's magic decode (kNib4M) takes these as they are.
__device__ __forceinline__ void biased_codes_bf16(uint32_t c, uint32_t& p01, uint32_t& p23) {
  constexpr uint32_t kHi = 0x43434343u;
  p01 = __byte_perm(c, kHi, 0x5140);
  p23 = __byte_perm(c, kHi, 0x7362);
}

// Four integer codes q < 128 (bytes of c, in K order: s21's f + 4h, nib4's
// 0..15) -> their bf16 values, pairs (0, 1) and (2, 3): biased_codes_bf16,
// then (128 + q) * 1 - 128 in one bf16x2 fma is q exactly.
__device__ __forceinline__ void int_codes_bf16(uint32_t c, uint32_t& p01, uint32_t& p23) {
  constexpr uint32_t kOne = 0x3F803F80u, kMinus128 = 0xC300C300u;
  biased_codes_bf16(c, p01, p23);
  p01 = bf16x2_fma(p01, kOne, kMinus128);
  p23 = bf16x2_fma(p23, kOne, kMinus128);
}

// Four signed byte codes (bytes of c, in K order: the stored byte read as
// int8, -128..127) -> their bf16 values, pairs (0, 1) and (2, 3): the low
// seven bits under the high byte 0x43 are the bf16 of 128 + (b & 127), the
// sign bit under 0xC3 that of -128 (bit clear) or -256 (set), and one bf16x2
// fma adds them: (b & 127) - 128 * (b >> 7), exactly.
__device__ __forceinline__ void byte_codes_bf16(uint32_t c, uint32_t& p01, uint32_t& p23) {
  constexpr uint32_t kHi = 0x43434343u, kNeg = 0xC3C3C3C3u, kOne = 0x3F803F80u;
  const uint32_t m = c & 0x7F7F7F7Fu, sg = c & 0x80808080u;
  p01 = bf16x2_fma(__byte_perm(m, kHi, 0x5140), kOne, __byte_perm(sg, kNeg, 0x5140));
  p23 = bf16x2_fma(__byte_perm(m, kHi, 0x7362), kOne, __byte_perm(sg, kNeg, 0x7362));
}

// The widths-based decode of minifloat codes (one a byte: sign bit SB = E +
// M, then E exponent and M mantissa bits) to bf16: the magnitude bits
// shifted by sh = 7 - M are the bf16 of value * 2^(bias - 127), the
// exponent field landing on bf16's (subnormals on its subnormals), and one
// exact product by 2^(127 - bias) gives the value.  The bf16 is built
// bytewise: lo = the bits that stay in the low byte, hi = those above it
// (mhi: E - 1 bits) and the sign.
struct Bf16Dec {
  int sh, ssh;          // magnitude shift; the sign's shift to bit 7
  uint32_t mlo, mhi;    // per-byte masks of the low and high bf16 bytes
  uint32_t mult;        // 2^(127 - bias), twice
};
__device__ __forceinline__ Bf16Dec bf16_dec(int exp_bits, int mant_bits) {
  const int sh = 7 - mant_bits, sb = exp_bits + mant_bits;
  const uint32_t rep = 0x01010101u;
  const uint32_t m = (uint32_t)(254 - ((1 << (exp_bits - 1)) - 1)) << 7;
  return {sh, 7 - sb, ((0xFFu << sh) & 0xFFu) * rep, ((1u << (exp_bits - 1)) - 1u) * rep,
          m | (m << 16)};
}

// Four codes (bytes of c, in K order) -> their bf16 values, pairs (0, 1)
// and (2, 3).
__device__ __forceinline__ void codes_bf16(uint32_t c, const Bf16Dec& d, uint32_t& p01,
                                           uint32_t& p23) {
  const uint32_t lo = (c << d.sh) & d.mlo;
  const uint32_t hi = ((c >> (8 - d.sh)) & d.mhi) | ((c << d.ssh) & 0x80808080u);
  p01 = bf16x2_mul(__byte_perm(lo, hi, 0x5140), d.mult);
  p23 = bf16x2_mul(__byte_perm(lo, hi, 0x7362), d.mult);
}

// The bf16 bytes of the eight magnitudes of a 4-bit format, by the
// widths-based bit assembly: words 0, 1 the low bytes, 2, 3 the high ones.
__device__ __forceinline__ void lut4_bf16_table(int exp_bits, int mant_bits, uint32_t (&tab)[4]) {
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const uint32_t b = __bfloat16_as_ushort(__float2bfloat16(minifloat_value(c, exp_bits,
                                                                             mant_bits)));
    tab[c / 4] |= (b & 0xFFu) << (8 * (c % 4));
    tab[2 + c / 4] |= (b >> 8) << (8 * (c % 4));
  }
}

// The eight 4-bit codes of a nib4 word w (bytes: four packed rows of one
// channel, as lut4_grid2 takes them) -> their bf16 values, slab 0's rows
// (0, 1) and (2, 3) in s0, slab 1's in s1: the magnitudes select the low
// and the high bytes from tab (lut4_bf16_table), the signs (spread to bytes
// by prmt's sign mode) set bit 7 of the high ones.
__device__ __forceinline__ void lut4_bf16x2(uint32_t w, const uint32_t (&tab)[4], uint32_t (&s0)[2],
                                            uint32_t (&s1)[2]) {
  const uint32_t m = w & 0x77777777u;
  const uint32_t t = w ^ 0x80808080u;  // slab 1's sign bits unflipped
  const uint32_t t4 = t << 4;          // slab 0's sign bits at bit 7 of each byte
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // rows 2h, 2h + 1: bytes (row, slab) 00 01 10 11
    const uint32_t sel = h ? m >> 16 : m;
    const uint32_t sgn = prmt(t4, t, h ? 0xFBEAu : 0xD9C8u);
    const uint32_t lo = __byte_perm(tab[0], tab[1], sel);
    const uint32_t hi = __byte_perm(tab[2], tab[3], sel) | (sgn & 0x80808080u);
    s0[h] = __byte_perm(lo, hi, 0x6240);
    s1[h] = __byte_perm(lo, hi, 0x7351);
  }
}

// The eight affine nib4 codes of a word w (bytes: four packed rows of one
// channel, each the low nibble's code of slab 0 and the MSB-flipped high
// nibble's of slab 1) -> their bf16 values, slab 0's rows (0, 1) and (2, 3)
// in s0, slab 1's in s1: one mask gives the low codes, one shift and one
// LOP3 (mask, flip) the logical high codes q, int_codes_bf16 their values
// (MAGIC, kNib4M: biased_codes_bf16, the values 128 + q).
template <bool MAGIC = false>
__device__ __forceinline__ void nib4_bf16x2(uint32_t w, uint32_t (&s0)[2], uint32_t (&s1)[2]) {
  const uint32_t lo = w & 0x0F0F0F0Fu, hi = ((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
  if constexpr (MAGIC) {
    biased_codes_bf16(lo, s0[0], s0[1]);
    biased_codes_bf16(hi, s1[0], s1[1]);
  } else {
    int_codes_bf16(lo, s0[0], s0[1]);
    int_codes_bf16(hi, s1[0], s1[1]);
  }
}

// d += a (16 x 8, row) * b (8 x 8, col), TF32 in (f32 registers), f32 sums.
// Lane (g, t): a = A[g][t], A[g + 8][t], A[g][t + 4], A[g + 8][t + 4]; b =
// B[t][g], B[t + 4][g]; d as mma_bf16's.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The probe's f32 decode (kNib4T) of byte j of a packed nib4 word w (the
// four bytes: four channels of one row): the f32 of the low code q (slab
// 0), or of the high nibble read as int8, (int8)(byte & 0xF0) = 16 (q - 8)
// (slab 1), as f32 bits; one int -> float convert a code.
__device__ __forceinline__ uint32_t nib4_f32(uint32_t w, int j, bool high) {
  const uint32_t b = (w >> (8 * j)) & 0xFFu;
  const int v = high ? (int)(int8_t)(b & 0xF0u) : (int)(b & 0x0Fu);
  return __float_as_uint((float)v);
}

constexpr int kSlabRowThreads = 1024;  // threads of the slab row pass, one block a row

// Sum (MAX=false) or maximum (MAX=true) of one value per thread of a
// kSlabRowThreads block: shuffles within each warp, then the warps' results
// through shared memory (two barriers).
template <bool MAX>
__device__ __forceinline__ float block_reduce_warps(float v, float* red) {
  constexpr int kWarps = kSlabRowThreads / kLanes;
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = MAX ? fmaxf(v, o) : v + o;
  }
  if (threadIdx.x % kLanes == 0) red[threadIdx.x / kLanes] = v;
  __syncthreads();
  float out = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) out = MAX ? fmaxf(out, red[w]) : out + red[w];
  __syncthreads();
  return out;
}

// Row pass of the slab kernel: int8 planes [PLANES][M][S][Kb32] (slab i's
// rows r < Kb hold K column i*Kb + r, the rest zero) and sx [M] from x [M,
// ldx], and, if xsum is not null, xsum [M][S*Kb/G], the sum of the group's
// codes (A16: 256*sum(hi) + sum(lo); A8: sum(q)) per group of G K columns:
// a warp quantizes a group and sums its codes by shuffles.  The codes:
// A16 (PLANES = 2) sx = max|x| / 32512, hi and lo of rint(x / sx); A8
// (PLANES = 1) sx = max|x| / 127, q = clip(rint(x / sx), +-127).
template <typename XT, bool NORM, int PLANES>
__global__ void __launch_bounds__(kSlabRowThreads)
quantize_rows_slab_kernel(const XT* __restrict__ x, int ldx, int k_logical, int S, int Kb,
                          int Kb32, int G, float eps, int8_t* __restrict__ xq,
                          float* __restrict__ sx, int* __restrict__ xsum, int M) {
  static_assert(PLANES == 1 || PLANES == 2, "A8: one plane; A16: two");
  __shared__ float red[kSlabRowThreads / kLanes];
  griddep_launch_dependents();  // the product kernel may start its weight copies
  const int m = blockIdx.x;
  const int t = threadIdx.x;
  const XT* xr = x + (size_t)m * ldx;
  // one pass: the sum of squares (NORM) and max|x|.  The quantizer sees
  // val(k) = x*r rounded to x's type, and rounding is monotone and odd, so
  // max|val(k)| is max|x| * r rounded the same way.
  float ss = 0.f, amax = 0.f;
  for (int k = t; k < k_logical; k += kSlabRowThreads) {
    const float v = to_f32(xr[k]);
    if (NORM) ss = fmaf(v, v, ss);
    amax = fmaxf(amax, fabsf(v));
  }
  float r = 1.f;
  if (NORM) {
    ss = block_reduce_warps<false>(ss, red);
    r = 1.0f / sqrtf(ss / (float)k_logical + eps);
  }
  amax = block_reduce_warps<true>(amax, red);
  if (NORM) amax = round_to(amax * r, XT());
  auto val = [&](int k) {
    const float v = to_f32(xr[k]);
    return NORM ? round_to(v * r, XT()) : v;
  };
  const float s = fmaxf(amax, 1e-8f) / (PLANES == 1 ? 127.0f : 32512.0f);
  if (t == 0) sx[m] = s;
  const int row_len = S * Kb32;
  int8_t* q0 = xq + (size_t)m * row_len;
  int8_t* q1 = q0 + (size_t)M * row_len;  // A16: the lo plane
  // one warp a group (G K columns of one slab): the codes and their sum
  const int lane = t % kLanes, warp = t / kLanes;
  const int ng = S * (Kb / G);
  for (int gi = warp; gi < ng; gi += kSlabRowThreads / kLanes) {
    const int k0 = gi * G;
    const int sl = k0 / Kb;
    int8_t* p0 = q0 + sl * Kb32 + (k0 - sl * Kb);
    int8_t* p1 = q1 + sl * Kb32 + (k0 - sl * Kb);
    int acc = 0;
    for (int j = lane; j < G; j += kLanes) {
      int hi = 0, lo = 0;
      if (k0 + j < k_logical) {
        const float q = rintf(val(k0 + j) / s);
        if (PLANES == 1) {
          hi = (int)fminf(fmaxf(q, -127.f), 127.f);
        } else {
          const int xi = (int)q;
          hi = (xi + 128) >> 8;
          lo = xi - (hi << 8);
        }
      }
      p0[j] = (int8_t)hi;
      if (PLANES == 2) p1[j] = (int8_t)lo;
      acc += PLANES == 1 ? hi : 256 * hi + lo;
    }
    if (xsum != nullptr) {
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) xsum[(size_t)m * ng + gi] = acc;
    }
  }
  const int pad = Kb32 - Kb;  // each slab's rows beyond Kb: zero
  for (int i = t; i < S * pad; i += kSlabRowThreads) {
    const int at = (i / pad) * Kb32 + Kb + i % pad;
    q0[at] = 0;
    if (PLANES == 2) q1[at] = 0;
  }
}

// Row pass of the bf16 family, where a call needs one (a pre-norm, or x
// that the product kernel cannot read in place): from x [M, ldx] bf16 (ldx
// = S*Kb, zero beyond k_logical), optionally after the weightless RMSNorm
// (f32 mean of squares over k_logical, r = 1/sqrt(ms + eps), x*r rounded to
// bf16), the copy xs [M][S][Kb32] (slab i's rows r < Kb hold K column i*Kb
// + r, the rest zero).
template <bool NORM>
__global__ void __launch_bounds__(kSlabRowThreads)
rows_bf16_slab_kernel(const __nv_bfloat16* __restrict__ x, int ldx, int k_logical, int S, int Kb,
                      int Kb32, float eps, __nv_bfloat16* __restrict__ xs) {
  __shared__ float red[kSlabRowThreads / kLanes];
  griddep_launch_dependents();  // the product kernel may start its weight copies
  const int m = blockIdx.x;
  const int t = threadIdx.x;
  const __nv_bfloat16* xr = x + (size_t)m * ldx;
  float r = 1.f;
  if (NORM) {
    float ss = 0.f;
    for (int k = t; k < k_logical; k += kSlabRowThreads) {
      const float v = __bfloat162float(xr[k]);
      ss = fmaf(v, v, ss);
    }
    ss = block_reduce_warps<false>(ss, red);
    r = 1.0f / sqrtf(ss / (float)k_logical + eps);
  }
  __nv_bfloat16* xo = xs + (size_t)m * S * Kb32;
  for (int k = t; k < S * Kb32; k += kSlabRowThreads) {
    const int sl = k / Kb32, row = k - sl * Kb32;
    __nv_bfloat16 b = __float2bfloat16(0.f);
    if (row < Kb)
      b = NORM ? __float2bfloat16(__bfloat162float(xr[sl * Kb + row]) * r) : xr[sl * Kb + row];
    xo[k] = b;
  }
}

// Partial products of one (BN-channel, MT-token, K-split) block into ws;
// with one split (gridDim.z == 1) the block finishes the output itself:
// out [M, n_out] = cast(sx * sum), the reduce kernel's arithmetic.
// xsrc: int8 planes [PLANES][M][S][Kb32]; xsum [M][S*Kb/G] int32 (null: LUT
// without zeros).  The bf16 family: xsrc bf16, token m's row r of slab i at
// m * x_ld + i * x_ls + r (valid for r < Kb; x_ld, x_ls multiples of 8,
// 16-byte aligned), no xsum (the kernel sums x itself where BZ: the
// artifact has zeros, z not null; always for s21 and affine nib4), no sx,
// bf16 out.  NORM (bf16 affine nib4 or byte, with BZ): the kernel also sums x^2 of
// the rows it stages, per token; with one split it scales the output by
// rsqrt(sum / k_logical + eps), else the blocks of channel tile 0 write
// their split's sums to xsq [splits, M] for the reduce.
// qw [A Kb, N] bytes; kc a multiple of 32 P.  LUT: nib4 exp_bits +
// mant_bits = 3; nq42 exp_bits 1 or 2 (bf16: any E + M = 5), mant_bits 5 -
// exp_bits; byte (bf16) any 1 + E + M <= 8; z may be null.  Affine (nib4,
// byte, s21): z not null, the format arguments unused.
template <int LAYOUT, int NT, bool VEC16, bool BZ = false, bool NORM = false, int PLANES = 2>
__global__ void __launch_bounds__(SlabTile<LAYOUT, NT>::THREADS,
                                  SlabTile<LAYOUT, NT>::BLOCKS_PER_SM)
wa_slab_mma_kernel(const void* __restrict__ xsrc, const void* __restrict__ xsum, int M,
                   const uint8_t* __restrict__ qw,
                   const float* __restrict__ s, long long s_rs, long long s_cs,
                   const float* __restrict__ z, long long z_rs, long long z_cs,
                   float* __restrict__ ws, void* __restrict__ out,
                   const float* __restrict__ sx, int out_bf16, int N, int n_out, int Kb,
                   int Kb32, int G, int kc, int exp_bits, int mant_bits, int x_ld, int x_ls,
                   float* __restrict__ xsq, int k_logical, float eps) {
  using T = SlabTile<LAYOUT, NT>;
  constexpr bool BF = T::BF;
  constexpr int L = T::L;
  constexpr bool LUT = L == kLut4 || L == kLut6 || LAYOUT == kLut8B;
  constexpr bool TF = LAYOUT == kNib4T;  // the probe's f32 decode: TF32 products
  constexpr int S = T::S, A = T::A, P = T::P, V = T::V, SW = T::SW, CT = T::CT, W = T::W;
  constexpr int MT = T::MT;
  constexpr int BN = T::BN, NTH = T::THREADS, STAGES = T::STAGES, PITCH = T::PITCH;
  static_assert(!NORM || (BF && BZ && (LAYOUT == kNib4B || LAYOUT == kByteB)),
                "the epilogue norm: bf16 affine nib4 or byte");
  static_assert(PLANES == 2 || (!BF && !LUT), "one plane (A8): the int8 affine layouts");
  extern __shared__ __align__(16) uint8_t slab_smem[];
  const int8_t* xq = static_cast<const int8_t*>(xsrc);
  const int tid = threadIdx.x;
  const int lane = tid % kLanes, warp = tid / kLanes;
  const int g = lane / 4, t = lane % 4;
  const int grp = warp % V;
  const int slab = grp % (S / SW) * SW;  // the warp's (first) slab
  const int part = P == 1 ? 0 : grp / (S / SW);
  const int cb = (warp / V) * 16 * CT;  // the warp's first channel in the block
  const int n_blk = blockIdx.x * BN;
  const int m0 = blockIdx.y * MT;
  const int k0 = blockIdx.z * kc;
  const int k1 = min(Kb, k0 + kc);
  const int kq = kc / P;                // rows a part
  const int pk0 = k0 + part * kq;       // the warp's part: rows [pk0, pk1)
  const int pk1 = min(k1, pk0 + kq);
  const int ngroups = S * (Kb / G);
  const bool has_z = BF ? BZ : !LUT || z != nullptr;
  const uint32_t wide = exp_bits == 2 ? 0xFFFFFFFFu : 0u;  // nq42: E2M3 (else E1M4)
  const float mult = LUT && !BF ? ldexpf(1.f, 1 - mant_bits - ((1 << (exp_bits - 1)) - 1)) : 1.f;
  const SlabFields fields = slab_fields<L == kLut6>(slab);
  // nib4 LUT: grid bytes of codes 0..7, then negated (int8); the bf16
  // bytes of their values (bf16 decode tile)
  uint32_t tab[4] = {0u, 0u, 0u, 0u};
  if constexpr (L == kLut4 && !BF) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const uint32_t v = (uint32_t)minifloat_int(c, exp_bits, mant_bits) & 0xFFu;
      tab[c / 4] |= v << (8 * (c % 4));
      tab[2 + c / 4] |= ((0u - v) & 0xFFu) << (8 * (c % 4));
    }
  } else if constexpr (BF && SW == 2 && L == kLut4) {
    lut4_bf16_table(exp_bits, mant_bits, tab);
  }
  Bf16Dec dec = {};
  if constexpr (BF && LUT) dec = bf16_dec(exp_bits, mant_bits);

  // Copies of the block's windows, in order, into the ring: each thread its
  // share of weight chunks of CB bytes (16, or 4 where N or qw is not
  // 16-byte aligned), zero-filled at and beyond the range's end k1 and
  // beyond N, and of x chunks of 16 bytes, zero-filled for tokens beyond M
  // (and, with parts, rows beyond k1; bf16: rows beyond Kb).  Chunk i of a
  // window is column chunk i % (BN / CB) of row (i / (BN / CB)) % 32 of
  // array (or part) i / CPA.  Where NTH is a multiple of CPA a thread's
  // chunks share one row and column (array or part tid / CPA, then every
  // NTH / CPA on), so it carries one source pointer and one row, stepped by
  // a window (32 rows) per copy; otherwise (4-byte chunks) one of each per
  // chunk.
  constexpr int CB = VEC16 ? 16 : 4;
  constexpr int CPA = kSlabWin * (BN / CB);                // chunks an array a window
  constexpr int WTOTAL = A * P * CPA;                      // weight chunks a window
  constexpr int WCH = (WTOTAL + NTH - 1) / NTH;            // weight chunks a thread
  constexpr bool SHARED_ROW = NTH % CPA == 0;
  constexpr int NP = SHARED_ROW ? 1 : WCH;                 // carried pointers
  constexpr int XTOTAL = S * P * (BF ? 2 : PLANES) * MT * 2;  // x chunks a window
  constexpr int XCH = (XTOTAL + NTH - 1) / NTH;
  static_assert(SHARED_ROW || CPA % NTH == 0, "whole rounds");
  const uint32_t smem0 = smem_u32(slab_smem);
  const int ap_rows = A == 1 ? kq : Kb;  // source rows between arrays (or parts)
  const size_t a_step = (size_t)(SHARED_ROW ? NTH / CPA : 0) * ap_rows * N;
  const int r_step = A == 1 && SHARED_ROW ? (NTH / CPA) * kq : 0;  // and range rows
  const uint8_t* w_src[NP];
  int w_row[NP], w_bytes[NP];
  uint32_t w_dst[WCH];
#pragma unroll
  for (int j = 0; j < WCH; ++j) {
    const int i = tid + j * NTH;
    const int a = i / CPA, c = i % (BN / CB), row = (i / (BN / CB)) % kSlabWin;
    const int col = n_blk + CB * c;
    if (j < NP) {
      w_row[j] = k0 + (A == 1 ? a * kq : 0) + row;
      w_bytes[j] = max(0, min(CB, N - col));
      w_src[j] = qw + ((size_t)a * ap_rows + k0 + row) * N + col;
    }
    // row 8t + i of the window sits at position 4i + t
    w_dst[j] = ((a * kSlabWin + 4 * (row % 8) + row / 8) * PITCH) * 4 + CB * c;
  }
  const int8_t* x_src[XCH];
  int x_row[XCH];
  uint32_t x_dst[XCH];
#pragma unroll
  for (int j = 0; j < XCH; ++j) {
    const int i = tid + j * NTH;
    if constexpr (BF) {  // 16-byte quarter h of token tok's 32 rows of (part, slab) v
      const int h = i % 4, tok = (i / 4) % MT, v = i / (4 * MT);
      const int m = m0 + tok;
      const int rows0 = k0 + (P == 1 ? 0 : v / S) * kq + 8 * h;
      x_row[j] = rows0;
      x_src[j] = i < XTOTAL && m < M
          ? reinterpret_cast<const int8_t*>(static_cast<const __nv_bfloat16*>(xsrc) +
                                            (size_t)m * x_ld + (size_t)(v % S) * x_ls + rows0)
          : nullptr;
      x_dst[j] = T::W_BYTES + (v * MT + tok) * 2 * kSlabWin + 16 * h;
    } else {
      // sp = (part * S + slab) * PLANES + plane
      const int h = i % 2, tok = (i / 2) % MT, sp = i / (2 * MT);
      const int m = m0 + tok;
      const int v = sp / PLANES, rows0 = k0 + (P == 1 ? 0 : v / S) * kq + 16 * h;
      x_row[j] = rows0;
      x_src[j] = i < XTOTAL && m < M
          ? xq + (((size_t)(sp % PLANES) * M + m) * S + v % S) * Kb32 + rows0 : nullptr;
      x_dst[j] = T::W_BYTES + (sp * MT + tok) * kSlabWin + 16 * h;
    }
  }
  auto load_weights = [&](int st) {  // the next window's weight rows
    const uint32_t base = smem0 + st * T::STAGE;
#pragma unroll
    for (int j = 0; j < WCH; ++j) {
      if (WTOTAL % NTH == 0 || tid + j * NTH < WTOTAL) {
        const int p = SHARED_ROW ? 0 : j;
        const int bytes = w_row[p] + (SHARED_ROW ? j * r_step : 0) < k1 ? w_bytes[p] : 0;
        const uint8_t* src = bytes ? w_src[p] + (SHARED_ROW ? j * a_step : 0) : qw;
        if (VEC16)
          cp_async16(base + w_dst[j], src, bytes);
        else
          cp_async4(base + w_dst[j], src, bytes);
      }
    }
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      w_src[p] += (size_t)kSlabWin * N;
      w_row[p] += kSlabWin;
    }
  };
  auto load_x = [&](int st) {  // the next window's x rows
    const uint32_t base = smem0 + st * T::STAGE;
#pragma unroll
    for (int j = 0; j < XCH; ++j) {
      if (XTOTAL % NTH == 0 || tid + j * NTH < XTOTAL) {
        if constexpr (BF) {  // 8 rows a chunk, rows of the slab only (Kb % 4 == 0)
          const int bytes = x_src[j] != nullptr ? 2 * min(8, max(0, Kb - x_row[j])) : 0;
          cp_async16(base + x_dst[j], bytes ? x_src[j] : static_cast<const int8_t*>(xsrc), bytes);
          if (x_src[j] != nullptr) x_src[j] += 2 * kSlabWin;
        } else {
          // with parts, a range's last part may end before its windows do
          const bool in = x_src[j] != nullptr && (P == 1 || x_row[j] < k1);
          cp_async16(base + x_dst[j], in ? x_src[j] : xq, in ? 16 : 0);
          if (in) x_src[j] += kSlabWin;
        }
        x_row[j] += kSlabWin;
      }
    }
  };

  float acc[CT][NT][4];
  // per slab of the warp, per group: int8: per plane (A16: hi, lo) int32; bf16: f32
  int ia[SW][CT][NT][BF ? 1 : PLANES][4];
  float pf[SW][CT][NT][BF ? 4 : 1];
#pragma unroll
  for (int c = 0; c < CT; ++c)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[c][nt][i] = 0.f;
#pragma unroll
        for (int sw = 0; sw < SW; ++sw) {
          if constexpr (BF) {
            pf[sw][c][nt][i] = 0.f;
          } else {
#pragma unroll
            for (int p = 0; p < PLANES; ++p) ia[sw][c][nt][p][i] = 0;
          }
        }
      }
  // the ending segment's sides and sums, per slab of the warp
  float sc[SW][CT][2], zc[SW][CT][2], xs_f[SW][NT][2];
  float xk[SW][NT][2] = {};  // bf16 with zeros: the segment's sums of x, per token
  float xq2[NT] = {};        // NORM: the lane's sum of x^2 (token 8 nt + g), all segments

  // Scales and zeros of group gi of the warp's slabs for the lane's
  // channels, and the group's activation sums of its tokens where this
  // warp's part holds the group's first row.
  auto load_sides = [&](int gi) {
#pragma unroll
    for (int sw = 0; sw < SW; ++sw) {
      const long long grow = (long long)(slab + sw) * (Kb / G) + gi;
      const int chb = n_blk + cb + 4 * W * g;  // the lane's first channel; its 4 W follow
      const float* sp = s + grow * s_rs + (long long)chb * s_cs;
      const float* zp = has_z ? z + grow * z_rs + (long long)chb * z_cs : nullptr;
      const int scs = (int)s_cs, zcs = (int)z_cs;
      if (scs == 1 && (!has_z || zcs == 1) && chb + 2 * CT <= N &&
          (reinterpret_cast<uintptr_t>(sp) | reinterpret_cast<uintptr_t>(zp)) % 16 == 0) {
        // contiguous side rows: the lane's 2 CT channels in 16-byte loads
#pragma unroll
        for (int q = 0; q < CT / 2; ++q) {
          const float4 sv = __ldg(reinterpret_cast<const float4*>(sp) + q);
          sc[sw][2 * q][0] = sv.x; sc[sw][2 * q][1] = sv.y;
          sc[sw][2 * q + 1][0] = sv.z; sc[sw][2 * q + 1][1] = sv.w;
          if (has_z) {
            const float4 zv = __ldg(reinterpret_cast<const float4*>(zp) + q);
            zc[sw][2 * q][0] = zv.x; zc[sw][2 * q][1] = zv.y;
            zc[sw][2 * q + 1][0] = zv.z; zc[sw][2 * q + 1][1] = zv.w;
          }
        }
      } else {
#pragma unroll
        for (int c = 0; c < CT; ++c)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int j = 2 * c + h;
            const bool ok = chb + j < N;
            sc[sw][c][h] = ok ? __ldg(sp + j * scs) : 0.f;
            zc[sw][c][h] = ok && has_z ? __ldg(zp + j * zcs) : 0.f;
          }
      }
      // affine nib4, the high slab: its codes are 16 q - 128, and the
      // group's epilogue takes s / 16 and z - 8 (the JAX kernel's mult and
      // zshift), i.e. sc = s / 16 and zc = 16 z - 128, so that sc * zc =
      // s * (z - 8), both exact powers of two away; bf16 s21 and affine
      // nib4 (its high codes decoded to q): the epilogue adds xsum * zc, so
      // zc = -(s * z)
      if (L == kNib4 && !BF && slab + sw == 1) {
#pragma unroll
        for (int c = 0; c < CT; ++c)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            sc[sw][c][h] *= 0.0625f;
            zc[sw][c][h] = fmaf(zc[sw][c][h], 16.f, -128.f);
          }
      } else if (LAYOUT == kNib4M) {
        // the probe's magic decode: values 128 + q, so zshift -128: zc =
        // -(s * (z + 128)), the 128 folded into the zero point
#pragma unroll
        for (int c = 0; c < CT; ++c)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            zc[sw][c][h] = -(sc[sw][c][h] * (zc[sw][c][h] + 128.f));
      } else if (TF) {
        // the probe's f32 decode: the high slab's values 16 (q - 8), so
        // the JAX mode's mult 1/16 and zshift 8: sc = s / 16, zc = -(s * (z
        // - 8)); the low slab's q: zc = -(s * z)
        const bool high = slab + sw == 1;
#pragma unroll
        for (int c = 0; c < CT; ++c)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            zc[sw][c][h] = -(sc[sw][c][h] * (high ? zc[sw][c][h] - 8.f : zc[sw][c][h]));
            if (high) sc[sw][c][h] *= 0.0625f;
          }
      } else if (BF && !LUT) {
#pragma unroll
        for (int c = 0; c < CT; ++c)
#pragma unroll
          for (int h = 0; h < 2; ++h) zc[sw][c][h] = -(sc[sw][c][h] * zc[sw][c][h]);
      }
      if (!BF && has_z && gi * G >= pk0) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int m = m0 + 8 * nt + 2 * t + u;
            xs_f[sw][nt][u] =
                m < M ? (float)__ldg(static_cast<const int*>(xsum) + (size_t)m * ngroups + grow)
                      : 0.f;
          }
      }
    }
  };

  // windows of a part: every warp walks as many as the first part has
  const int nwin = (min(k1, k0 + kq) - k0 + kSlabWin - 1) / kSlabWin;
  // the first windows' weights do not depend on the row pass: copy them
  // while it runs, then wait for its planes and sums
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nwin) load_weights(st);
    cp_async_commit();
  }
  griddep_wait();
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st)
    if (st < nwin) load_x(st);
  cp_async_commit();
  int gi_w = pk0 / G, gend_w = (gi_w + 1) * G;  // the group of the window's first row

  for (int w = 0; w < nwin; ++w) {
    if (w == 0)
      cp_async_wait<0>();
    else
      cp_async_wait<STAGES - 2>();
    __syncthreads();  // window w landed; every warp is done with window w - 1
    if (w + STAGES - 1 < nwin) {
      load_weights((w + STAGES - 1) % STAGES);
      load_x((w + STAGES - 1) % STAGES);
    }
    cp_async_commit();

    const int rw = pk0 + w * kSlabWin;
    if (P > 1 && rw >= pk1) continue;  // the range's last part ended early
    const int rend = min(rw + kSlabWin, pk1);
    while (gend_w <= rw) {
      ++gi_w;
      gend_w += G;
    }
    // the first segment ends in this window: fetch its sides now
    if (gend_w <= rend || rend == pk1) load_sides(gi_w);
    const uint8_t* base = slab_smem + (w % STAGES) * T::STAGE;
    const uint32_t* wst = reinterpret_cast<const uint32_t*>(base);
    // the staged rows of the warp's codes: its A (nibble) array, or its part
    const int arow = A == 1 ? part : slab % 2;

    // A fragments: rows 8t..8t+7 of the lane's 4 W channels, per slab;
    // int8: one m16n8k32 (MMA K slots 4t..4t+3, 16+4t..16+4t+3: rows
    // 8t..8t+7); bf16: MMA q (m16n8k16) takes rows 8t+4q..8t+4q+3 (K slots
    // 2t, 2t+1: rows +0, +1; 2t+8, 2t+9: rows +2, +3)
    // (TF: none here; each MMA step decodes its two rows in the segment)
    uint32_t afr[SW][CT][BF ? 2 : 1][4];
#pragma unroll
    for (int q = 0; q < (TF ? 0 : 2); ++q) {
      uint32_t code[4][W];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int pos = 4 * (4 * q + i) + t;
        uint32_t aw[W], bw[W];
        lds_words<W>(wst + (arow * kSlabWin + pos) * PITCH + cb / 4 + g * W, aw);
        if constexpr (A == 3) lds_words<W>(wst + (2 * kSlabWin + pos) * PITCH + cb / 4 + g * W, bw);
#pragma unroll
        for (int v = 0; v < W; ++v) {
          if constexpr (L == kByte || SW == 2)
            code[i][v] = aw[v];  // byte: the codes; nib4 decode tiles: decoded after the transpose
          else if constexpr (L == kNib4 && !BF)  // the low codes q, or the high ones as 16 q - 128
            code[i][v] = aw[v] & (slab ? 0xF0F0F0F0u : 0x0F0F0F0Fu);
          else if constexpr (BF && (L == kLut4 || L == kNib4))  // the logical codes
            code[i][v] = nib4_codes(aw[v], slab);
          else if constexpr (BF)
            code[i][v] = slab_codes<L == kLut6>(aw[v], bw[v], fields);
          else if constexpr (L == kLut4)
            code[i][v] = lut4_grid(nib4_codes(aw[v], slab), tab);
          else if constexpr (L == kLut6)
            code[i][v] = nq42_grid(slab_codes<true>(aw[v], bw[v], fields), wide);
          else
            code[i][v] = slab_codes<false>(aw[v], bw[v], fields);
        }
      }
#pragma unroll
      for (int v = 0; v < W; ++v) {
        const uint32_t rows4[4] = {code[0][v], code[1][v], code[2][v], code[3][v]};
        uint32_t col[SW][4];
        transpose4x4(rows4, col[0]);
        if constexpr (BF) {  // channel 4v + j: MMA row g + 8 (j % 2) of tile 2v + j / 2
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            uint32_t d[SW][2];
            if constexpr (SW == 2 && L == kNib4)
              nib4_bf16x2<LAYOUT == kNib4M>(col[0][j], d[0], d[1]);
            else if constexpr (SW == 2)
              lut4_bf16x2(col[0][j], tab, d[0], d[1]);
            else if constexpr (LAYOUT == kNib4M)  // the values 128 + q
              biased_codes_bf16(col[0][j], d[0][0], d[0][1]);
            else if constexpr (L == kS21 || L == kNib4)
              int_codes_bf16(col[0][j], d[0][0], d[0][1]);
            else if constexpr (LAYOUT == kByteB)
              byte_codes_bf16(col[0][j], d[0][0], d[0][1]);
            else if constexpr (LAYOUT == kLut8B)  // stored code - 128: the code
              codes_bf16(col[0][j] ^ 0x80808080u, dec, d[0][0], d[0][1]);
            else
              codes_bf16(col[0][j], dec, d[0][0], d[0][1]);
#pragma unroll
            for (int sw = 0; sw < SW; ++sw) {
              afr[sw][2 * v + j / 2][q][j % 2] = d[sw][0];
              afr[sw][2 * v + j / 2][q][2 + j % 2] = d[sw][1];
            }
          }
        } else {
          if constexpr (SW == 2) {  // both slabs' codes of the packed bytes, now per channel
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if constexpr (L == kNib4) {  // the low codes q; the high ones as 16 q - 128
                col[1][j] = col[0][j] & 0xF0F0F0F0u;
                col[0][j] &= 0x0F0F0F0Fu;
              } else {
                lut4_grid2(col[0][j], tab, col[0][j], col[1][j]);
              }
            }
          }
#pragma unroll
          for (int sw = 0; sw < SW; ++sw) {
            afr[sw][2 * v][0][2 * q] = col[sw][0];
            afr[sw][2 * v][0][2 * q + 1] = col[sw][1];
            afr[sw][2 * v + 1][0][2 * q] = col[sw][2];
            afr[sw][2 * v + 1][0][2 * q + 1] = col[sw][3];
          }
        }
      }
    }
    // B fragments (int8): token 8 nt + g, rows 8t..8t+7 of each plane of
    // each slab; bf16: loaded per token tile below
    uint32_t xb[SW][BF ? 1 : PLANES][BF ? 1 : NT][2];
    if constexpr (!BF) {
#pragma unroll
      for (int sw = 0; sw < SW; ++sw)
#pragma unroll
        for (int p = 0; p < PLANES; ++p)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int xs = part * S + slab + sw;
            const uint2 v = *reinterpret_cast<const uint2*>(
                base + T::W_BYTES + ((xs * PLANES + p) * MT + 8 * nt + g) * kSlabWin + 8 * t);
            xb[sw][p][nt][0] = v.x;
            xb[sw][p][nt][1] = v.y;
          }
    }

    int r = rw, gi = gi_w, gend = gend_w;
    while (r < rend) {
      const int se = min(rend, gend);
      uint32_t keep0 = 0xFFFFFFFFu, keep1 = 0xFFFFFFFFu;
      if (r != rw || se != rw + kSlabWin) {  // a segment of the window: rows [r, se) only
        const int row0 = rw + 8 * t;
        keep0 = row0 >= r && row0 < se ? 0xFFFFFFFFu : 0u;
        keep1 = row0 + 4 >= r && row0 + 4 < se ? 0xFFFFFFFFu : 0u;
      }
      if constexpr (BF) {
        // TF: the segment's x words, kept for the MMA steps below
        uint32_t xt[SW][TF ? NT : 1][4];
#pragma unroll
        for (int sw = 0; sw < SW; ++sw)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {  // token 8 nt + g, rows 8t..8t+7
            const uint4 v = *reinterpret_cast<const uint4*>(
                base + T::W_BYTES + ((part * S + slab + sw) * MT + 8 * nt + g) * 2 * kSlabWin +
                16 * t);
            const uint32_t xv[4] = {v.x & keep0, v.y & keep0, v.z & keep1, v.w & keep1};
            if constexpr (BZ) {  // the segment's sum of x: token g here, tokens 2t, 2t + 1 kept
              float sm = 0.f;
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const float lo = __uint_as_float(xv[e] << 16);
                const float hi = __uint_as_float(xv[e] & 0xFFFF0000u);
                sm += lo + hi;
                if constexpr (NORM) {  // x^2: only the warps of channel part 0 give it
                  if (cb == 0) xq2[nt] = fmaf(hi, hi, fmaf(lo, lo, xq2[nt]));
                }
              }
              sm += __shfl_xor_sync(0xffffffffu, sm, 1);
              sm += __shfl_xor_sync(0xffffffffu, sm, 2);
              xk[sw][nt][0] += __shfl_sync(0xffffffffu, sm, 8 * t);
              xk[sw][nt][1] += __shfl_sync(0xffffffffu, sm, 8 * t + 4);
            }
            if constexpr (TF) {
#pragma unroll
              for (int e = 0; e < 4; ++e) xt[sw][nt][e] = xv[e];
            } else {
#pragma unroll
              for (int c = 0; c < CT; ++c) {
                mma_bf16(pf[sw][c][nt], afr[sw][c][0], xv[0], xv[1]);
                mma_bf16(pf[sw][c][nt], afr[sw][c][1], xv[2], xv[3]);
              }
            }
          }
        if constexpr (TF) {
          // m16n8k8 step k takes rows 8t+2k (K slot t) and 8t+2k+1 (slot t +
          // 4) of each lane t: the A fragment holds their codes as f32, the
          // B fragment x word k of token g widened to f32 by a shift
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            uint32_t a[SW][CT][4];
#pragma unroll
            for (int e = 0; e < 2; ++e) {  // row 8t + 2k + e, staged at position 4 (2k + e) + t
              uint32_t aw[W];
              lds_words<W>(wst + (arow * kSlabWin + 4 * (2 * k + e) + t) * PITCH + cb / 4 + g * W,
                           aw);
#pragma unroll
              for (int v = 0; v < W; ++v)
#pragma unroll
                for (int j = 0; j < 4; ++j)  // channel 4v + j: row g + 8 (j % 2) of tile 2v + j / 2
#pragma unroll
                  for (int sw = 0; sw < SW; ++sw)
                    a[sw][2 * v + j / 2][2 * e + j % 2] = nib4_f32(aw[v], j, slab + sw == 1);
            }
#pragma unroll
            for (int sw = 0; sw < SW; ++sw)
#pragma unroll
              for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                for (int c = 0; c < CT; ++c)
                  mma_tf32(pf[sw][c][nt], a[sw][c], xt[sw][nt][k] << 16,
                           xt[sw][nt][k] & 0xFFFF0000u);
          }
        }
      } else {
#pragma unroll
        for (int sw = 0; sw < SW; ++sw)
#pragma unroll
          for (int c = 0; c < CT; ++c)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
              for (int p = 0; p < PLANES; ++p)
                mma_s8(ia[sw][c][nt][p], afr[sw][c][0], xb[sw][p][nt][0] & keep0,
                       xb[sw][p][nt][1] & keep1);
      }
      if (se == gend || se == pk1) {  // the group (or the part's share of it) ends
        if (r != rw) load_sides(gi);
        const bool first = gi * G >= pk0;  // this part holds the group's first row
#pragma unroll
        for (int sw = 0; sw < SW; ++sw)
#pragma unroll
          for (int c = 0; c < CT; ++c)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int h = i / 2, u = i % 2;  // D row half (channel), column (token)
                const float sv = sc[sw][c][h], zv = zc[sw][c][h];
                if constexpr (BF) {
                  acc[c][nt][i] = acc[c][nt][i] + pf[sw][c][nt][i] * sv;
                  if (BZ) acc[c][nt][i] = acc[c][nt][i] + xk[sw][nt][u] * zv;
                  pf[sw][c][nt][i] = 0.f;
                } else {
                  const float part_f = PLANES == 1 ? (float)ia[sw][c][nt][0][i]
                                       : (float)ia[sw][c][nt][0][i] * 256.f +
                                             (float)ia[sw][c][nt][PLANES - 1][i];
                  if (LUT) {
                    acc[c][nt][i] = acc[c][nt][i] + part_f * (sv * mult);
                    if (has_z && first) acc[c][nt][i] = acc[c][nt][i] + xs_f[sw][nt][u] * zv;
                  } else if (first) {
                    acc[c][nt][i] = acc[c][nt][i] + part_f * sv - xs_f[sw][nt][u] * (sv * zv);
                  } else {
                    acc[c][nt][i] = acc[c][nt][i] + part_f * sv;
                  }
#pragma unroll
                  for (int p = 0; p < PLANES; ++p) ia[sw][c][nt][p][i] = 0;
                }
              }
        if constexpr (BZ)
#pragma unroll
          for (int sw = 0; sw < SW; ++sw)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) xk[sw][nt][0] = xk[sw][nt][1] = 0.f;
      }
      r = se;
      if (se == gend) {
        ++gi;
        gend += G;
      }
    }
  }

  // the groups' partials meet in shared memory: [group][token][BN + 1]
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(slab_smem);
  constexpr int RP = BN + 1;
#pragma unroll
  for (int c = 0; c < CT; ++c)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ch = cb + 4 * (g * W + c / 2) + 2 * (c % 2) + i / 2;
        const int tok = 8 * nt + 2 * t + i % 2;
        red[(grp * MT + tok) * RP + ch] = acc[c][nt][i];
      }
  // NORM: each group's sums of x^2 per token (its rows, from the warp of
  // channel part 0), then per token their sum: the split's share, or with
  // one split the row factor
  __shared__ float sq_red[NORM ? V * MT : 1], r_tok[NORM ? MT : 1];
  if constexpr (NORM) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float v = xq2[nt];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if (cb == 0 && t == 0) sq_red[grp * MT + 8 * nt + g] = v;
    }
  }
  __syncthreads();
  if constexpr (NORM) {
    if (tid < MT) {
      float ss = 0.f;
#pragma unroll
      for (int pr = 0; pr < V; ++pr) ss += sq_red[pr * MT + tid];
      if (gridDim.z == 1)
        r_tok[tid] = 1.0f / sqrtf(ss / (float)k_logical + eps);
      else if (blockIdx.x == 0 && m0 + tid < M)
        xsq[(size_t)blockIdx.z * M + m0 + tid] = ss;
    }
    __syncthreads();
  }
  for (int i = tid; i < MT * BN; i += NTH) {
    const int tok = i / BN, ch = i % BN;
    float v = 0.f;
#pragma unroll
    for (int pr = 0; pr < V; ++pr) v += red[(pr * MT + tok) * RP + ch];
    const int m = m0 + tok, n = n_blk + ch;
    if (gridDim.z > 1) {
      if (m < M && n < N) ws[((size_t)blockIdx.z * M + m) * N + n] = v;
    } else if (m < M && n < n_out) {  // one split: the reduce's epilogue here
      if (!BF) v *= sx[m];
      if constexpr (NORM) v *= r_tok[tok];
      if (out_bf16)
        store_out(static_cast<__nv_bfloat16*>(out) + (size_t)m * n_out + n, v);
      else
        store_out(static_cast<float*>(out) + (size_t)m * n_out + n, v);
    }
  }
  griddep_launch_dependents();  // the K-split reduce may start
}

// Launch `kernel` on `st` so that it may start before the kernel before it
// ends (programmatic dependent launch; the kernel calls griddep_wait before
// it reads that kernel's output).
template <typename... KArgs, typename... Args>
cudaError_t launch_after(void (*kernel)(KArgs...), dim3 grid, dim3 block, size_t smem,
                         cudaStream_t st, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<KArgs>(args)...);
}

// Bytes of the xq scratch the wrapper allocates (must match
// slab_scratch_bytes in ops/kernels/dequant_matmul.py): the planes
// [PLANES][M][S][Kb32], then, where the kernel reads sums, xsum
// [M][S*Kb/G] int32 (the planes' size is a multiple of 32 bytes).
inline long long slab_planes_bytes(int planes, int M, int S, int Kb) {
  return (long long)planes * M * S * ((Kb + kSlabWin - 1) / kSlabWin * kSlabWin);
}

template <bool NORM, int PLANES>
cudaError_t launch_rows_slab(const void* x, int x_bf16, int k_logical, int S, int Kb, int G,
                             float eps, void* xq, void* sx, int* xsum, int M,
                             cudaStream_t st) {
  const int Kb32 = (Kb + kSlabWin - 1) / kSlabWin * kSlabWin;
  int8_t* q = static_cast<int8_t*>(xq);
  float* sp = static_cast<float*>(sx);
  if (x_bf16)
    quantize_rows_slab_kernel<__nv_bfloat16, NORM, PLANES><<<M, kSlabRowThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), k_logical, k_logical, S, Kb, Kb32, G, eps, q,
        sp, xsum, M);
  else
    quantize_rows_slab_kernel<float, NORM, PLANES><<<M, kSlabRowThreads, 0, st>>>(
        static_cast<const float*>(x), k_logical, k_logical, S, Kb, Kb32, G, eps, q, sp, xsum,
        M);
  return cudaGetLastError();
}

template <int PLANES>
cudaError_t rows_slab(const void* x, int x_bf16, int k_logical, int S, int Kb, int G, int norm,
                      float eps, void* xq, void* sx, int* xsum, int M, cudaStream_t st) {
  return norm ? launch_rows_slab<true, PLANES>(x, x_bf16, k_logical, S, Kb, G, eps, xq, sx,
                                               xsum, M, st)
              : launch_rows_slab<false, PLANES>(x, x_bf16, k_logical, S, Kb, G, eps, xq, sx,
                                                xsum, M, st);
}

template <int LAYOUT, int NT, bool BZ = false, bool NORM = false, int PLANES = 2>
cudaError_t launch_slab_mma_nt(const void* xq, const void* xsum, int M, const void* qw,
                               const void* s, long long s_rs, long long s_cs, const void* z,
                               long long z_rs, long long z_cs, void* ws, void* out,
                               const void* sx, int x_bf16, int N, int n_out, int Kb, int G,
                               int kc, int splits, int exp_bits, int mant_bits,
                               cudaStream_t st, int x_ld = 0, int x_ls = 0,
                               float* xsq = nullptr, int k_logical = 0, float eps = 0.f) {
  using T = SlabTile<LAYOUT, NT>;
  constexpr int SM = T::SMEM;
  static bool attr_set = false;  // one attribute call per instantiation
  if (!attr_set) {
    cudaError_t err =
        cudaFuncSetAttribute(wa_slab_mma_kernel<LAYOUT, NT, true, BZ, NORM, PLANES>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, SM);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(wa_slab_mma_kernel<LAYOUT, NT, false, BZ, NORM, PLANES>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, SM);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const int Kb32 = (Kb + kSlabWin - 1) / kSlabWin * kSlabWin;
  const dim3 grid((N + T::BN - 1) / T::BN, (M + T::MT - 1) / T::MT, splits);
  // 16-byte weight copies where every row of the block's columns is 16-byte aligned
  const bool vec16 = N % 16 == 0 && reinterpret_cast<uintptr_t>(qw) % 16 == 0;
  return launch_after(
      vec16 ? wa_slab_mma_kernel<LAYOUT, NT, true, BZ, NORM, PLANES>
            : wa_slab_mma_kernel<LAYOUT, NT, false, BZ, NORM, PLANES>,
      grid, dim3(T::THREADS), SM, st, xq, xsum, M, static_cast<const uint8_t*>(qw),
      static_cast<const float*>(s), s_rs, s_cs, static_cast<const float*>(z), z_rs, z_cs,
      static_cast<float*>(ws), out, static_cast<const float*>(sx), x_bf16, N, n_out, Kb, Kb32,
      G, kc, exp_bits, mant_bits, x_ld, x_ls, xsq, k_logical, eps);
}

// The whole call: row pass, tensor-core partial products, reduce.  x is
// [M, k_logical] contiguous; xq (slab_planes_bytes, then the sums), sx [M]
// f32 and ws [splits, M, N] are scratch from the wrapper.  Kb is the slab
// rows: K (byte), K/2 (nib4, affine and LUT), the B rows K/8 (s21) or the
// quad rows K/4 (nq42); qw is [Kb, N] (byte, nib4) or [3 Kb, N].  kc is a
// multiple of 32 P (SlabTile::P).  exp_bits, mant_bits: the LUT format
// (nib4: fp4, E + M = 3; nq42: E1M4 or E2M3); its z may be null.  PLANES:
// 2 for A16, 1 for A8 (the affine layouts: one int8 plane, sx = max|x| /
// 127, half the staged x and half the MMAs).
template <int LAYOUT, int PLANES = 2>
int launch_wa_slab(const void* x, int x_bf16, int k_logical, int norm, float eps,
                   const void* qw, const void* s, long long s_rs, long long s_cs,
                   const void* z, long long z_rs, long long z_cs, void* xq, void* sx,
                   void* ws, void* out, int M, int N, int n_out, int Kb, int G, int kc,
                   int splits, void* stream, int exp_bits = 0, int mant_bits = 0) {
  static_assert(LAYOUT == kNib4 || LAYOUT == kByte || LAYOUT == kS21 || LAYOUT == kLut4 ||
                    LAYOUT == kLut6,
                "an int8 slab layout");
  constexpr bool LUT = LAYOUT == kLut4 || LAYOUT == kLut6;
  static_assert(PLANES == 2 || (PLANES == 1 && !LUT), "A8: the affine layouts");
  constexpr int NT_WIDE = slab_tile_nt(9, LAYOUT, PLANES);
  constexpr int S = SlabTile<LAYOUT, 1>::S, P = SlabTile<LAYOUT, 1>::P;
  static_assert(SlabTile<LAYOUT, NT_WIDE>::P == P, "one part count a layout");
  if (M <= 0 || N <= 0 || N % 4 || n_out > N || Kb <= 0 || Kb % 4 || G <= 0 || G % 4 ||
      Kb % G || kc <= 0 || kc % (kSlabWin * P) || splits <= 0 ||
      (long long)kc * splits < Kb || (long long)kc * (splits - 1) >= Kb || k_logical <= 0 ||
      k_logical > S * Kb || (!LUT && z == nullptr) || s_cs < 0 || s_cs > (1 << 24) ||
      z_cs < 0 || z_cs > (1 << 24) ||
      (LAYOUT == kLut4 && (exp_bits < 1 || mant_bits < 0 || exp_bits + mant_bits != 3)) ||
      (LAYOUT == kLut6 && (exp_bits < 1 || exp_bits > 2 || exp_bits + mant_bits != 5)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* planes = static_cast<int8_t*>(xq);
  int* xsum = LUT && z == nullptr
      ? nullptr : reinterpret_cast<int*>(planes + slab_planes_bytes(PLANES, M, S, Kb));
  cudaError_t err = rows_slab<PLANES>(x, x_bf16, k_logical, S, Kb, G, norm, eps, xq, sx, xsum,
                                      M, st);
  if (err != cudaSuccess) return (int)err;
  err = slab_tile_nt(M, LAYOUT, PLANES) == 1
      ? launch_slab_mma_nt<LAYOUT, 1, false, false, PLANES>(
            planes, xsum, M, qw, s, s_rs, s_cs, z, z_rs, z_cs, ws, out, sx, x_bf16, N, n_out,
            Kb, G, kc, splits, exp_bits, mant_bits, st)
      : launch_slab_mma_nt<LAYOUT, NT_WIDE, false, false, PLANES>(
            planes, xsum, M, qw, s, s_rs, s_cs, z, z_rs, z_cs, ws, out, sx, x_bf16, N, n_out,
            Kb, G, kc, splits, exp_bits, mant_bits, st);
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long total = (long long)M * n_out;
  const dim3 rgrid((unsigned)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096));
  err = x_bf16 ? launch_after(w4_reduce_kernel<true, __nv_bfloat16>, rgrid, dim3(256), 0, st,
                              static_cast<const float*>(ws), static_cast<const float*>(sx),
                              static_cast<__nv_bfloat16*>(out), M, N, n_out, splits, 0, 0.f)
               : launch_after(w4_reduce_kernel<true, float>, rgrid, dim3(256), 0, st,
                              static_cast<const float*>(ws), static_cast<const float*>(sx),
                              static_cast<float*>(out), M, N, n_out, splits, 0, 0.f);
  return (int)err;
}


// The bf16 family's whole call (LAYOUT kLut4B, kLut6B, kS21B, kNib4B,
// kByteB, kLut8B, or the probe's kNib4M, kNib4T, which take no norm): y
// = x @ dequant(qw), bf16 x [M, ldx] (ldx = S*Kb, zero beyond k_logical),
// bf16 out [M, n_out].  The row pass runs only where the call needs it:
// with norm on a layout without the epilogue norm, or x_copy (x is not
// 16-byte aligned, or ldx or Kb is no multiple of 8), it writes the copy xs
// [M][S][Kb32] bf16 (scratch from the wrapper: bf16_mma_scratch_bytes in
// ops/kernels/dequant_matmul.py) that the product kernel then reads
// (normalized under norm); otherwise the product kernel reads x itself.
// EPI_NORM (kNib4B, the prenorm form; norm must be 1): x is never
// normalized, the product kernel applies r = rsqrt(sum(x^2) / k_logical +
// eps) to the f32 sum (with a K-split the reduce does, from the splits'
// sums of x^2 that the kernel writes after ws).  ws [splits, M, N] (EPI_NORM:
// then [splits, M] more) is scratch too; kc is a multiple of 32 P
// (SlabTile<LAYOUT, NT>::P at the call's token tile).  Kb: K/2 (nib4), the
// B rows K/8 (s21), the quad rows K/4 (nq42) or K (byte).  exp_bits,
// mant_bits: the LUT format (nib4: E + M = 3; nq42: E + M = 5; byte: E >=
// 1, 1 + E + M <= 8), decoded from its widths, z may be null (symmetric);
// the affine layouts (s21, nib4, byte): both 0, z not null.
template <int LAYOUT, bool EPI_NORM = false>
int launch_bf16_mma(const void* x, int ldx, int x_copy, int k_logical, int norm, float eps,
                   const void* qw, const void* s, long long s_rs, long long s_cs,
                   const void* z, long long z_rs, long long z_cs, void* xs, void* ws, void* out,
                   int M, int N, int n_out, int Kb, int G, int kc, int splits, int exp_bits,
                   int mant_bits, void* stream) {
  static_assert(SlabTile<LAYOUT, 1>::BF,
                "a bf16 layout: kLut4B, kLut6B, kS21B, kNib4B, kByteB, kLut8B, kNib4M or kNib4T");
  static_assert(!EPI_NORM || LAYOUT == kNib4B || LAYOUT == kByteB,
                "the epilogue norm: affine nib4 or byte (the w4 and w8 prenorm forms)");
  constexpr bool LUT = LAYOUT == kLut4B || LAYOUT == kLut6B || LAYOUT == kLut8B;
  // the LUT formats each layout takes: nib4 E + M = 3, nq42 E + M = 5,
  // byte 1 + E + M <= 8 (lut8's: fp8, and fp3, fp5, fp7 and the
  // byte-per-code fp6 stored a byte a code)
  const bool fmt_ok = exp_bits >= 1 && mant_bits >= 0 &&
                      (LAYOUT == kLut4B   ? exp_bits + mant_bits == 3
                       : LAYOUT == kLut6B ? exp_bits + mant_bits == 5
                                          : exp_bits + mant_bits <= 7);
  constexpr int S = SlabTile<LAYOUT, 1>::S;
  constexpr int NT_WIDE = slab_tile_nt(9, LAYOUT);
  const bool wide = slab_tile_nt(M, LAYOUT) != 1;
  const int P = wide ? SlabTile<LAYOUT, NT_WIDE>::P : SlabTile<LAYOUT, 1>::P;
  const bool row_norm = norm && !EPI_NORM;  // the row pass normalizes x
  const bool copy = x_copy || row_norm;
  if (M <= 0 || N <= 0 || N % 4 || n_out > N || Kb <= 0 || Kb % 4 || G <= 0 || G % 4 ||
      Kb % G || kc <= 0 || kc % (kSlabWin * P) || splits <= 0 ||
      (long long)kc * splits < Kb || (long long)kc * (splits - 1) >= Kb || k_logical <= 0 ||
      k_logical > S * Kb || ldx != S * Kb || s_cs < 0 || s_cs > (1 << 24) || z_cs < 0 ||
      z_cs > (1 << 24) ||
      (LUT && !fmt_ok) ||
      (!LUT && (exp_bits != 0 || mant_bits != 0 || z == nullptr)) ||
      // affine nib4 and byte: no normalized copy (the JAX prenorm kernels
      // scale the f32 sum): a pre-norm is the epilogue norm
      ((LAYOUT == kNib4B || LAYOUT == kByteB) && (norm != 0) != EPI_NORM) ||
      // the probe's layouts: no pre-norm
      ((LAYOUT == kNib4M || LAYOUT == kNib4T) && norm != 0) ||
      (!copy && (ldx % 8 || Kb % 8 || reinterpret_cast<uintptr_t>(x) % 16)) ||
      (copy && xs == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int Kb32 = (Kb + kSlabWin - 1) / kSlabWin * kSlabWin;
  __nv_bfloat16* xc = static_cast<__nv_bfloat16*>(xs);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  cudaError_t err = cudaSuccess;
  if (copy) {
    if (row_norm)
      rows_bf16_slab_kernel<true><<<M, kSlabRowThreads, 0, st>>>(xb, ldx, k_logical, S, Kb, Kb32,
                                                                 eps, xc);
    else
      rows_bf16_slab_kernel<false><<<M, kSlabRowThreads, 0, st>>>(xb, ldx, k_logical, S, Kb,
                                                                  Kb32, eps, xc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const void* xsrc = copy ? static_cast<const void*>(xc) : x;
  const int x_ld = copy ? S * Kb32 : ldx, x_ls = copy ? Kb32 : Kb;
  float* xsq = EPI_NORM ? static_cast<float*>(ws) + (size_t)splits * M * N : nullptr;
#define IWOQ_BF16_MMA(NT, BZ)                                                                 \
  launch_slab_mma_nt<LAYOUT, NT, BZ, EPI_NORM>(xsrc, nullptr, M, qw, s, s_rs, s_cs, z, z_rs,  \
                                               z_cs, ws, out, nullptr, 1, N, n_out, Kb, G, kc, \
                                               splits, exp_bits, mant_bits, st, x_ld, x_ls,   \
                                               xsq, k_logical, eps)
  if constexpr (LUT) {
    const bool bz = z != nullptr;
    err = wide ? (bz ? IWOQ_BF16_MMA(NT_WIDE, true) : IWOQ_BF16_MMA(NT_WIDE, false))
               : (bz ? IWOQ_BF16_MMA(1, true) : IWOQ_BF16_MMA(1, false));
  } else {  // an affine artifact always has zeros
    err = wide ? IWOQ_BF16_MMA(NT_WIDE, true) : IWOQ_BF16_MMA(1, true);
  }
#undef IWOQ_BF16_MMA
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long total = (long long)M * n_out;
  const dim3 rgrid((unsigned)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096));
  return (int)launch_after(w4_reduce_kernel<EPI_NORM, __nv_bfloat16, EPI_NORM>, rgrid, dim3(256),
                           0, st, static_cast<const float*>(ws),
                           static_cast<const float*>(xsq), static_cast<__nv_bfloat16*>(out), M,
                           N, n_out, splits, k_logical, eps);
}

}  // namespace iwoq

// The slab kernels' row pass alone, for checking its codes and sums against
// the plain versions: planes [bits / 8][M][slabs][Kb32] and sx [M] into xq
// and sx, and the group sums [M][slabs*Kb/G] into xsum (null: none).
extern "C" int iwoq_quantize_rows_slab(const void* x, int x_bf16, int k_logical, int slabs,
                                       int Kb, int G, int bits, int norm, float eps, void* xq,
                                       void* sx, void* xsum, int M, void* stream) {
  if (M <= 0 || k_logical <= 0 || (slabs != 1 && slabs != 2 && slabs != 4 && slabs != 8) ||
      Kb <= 0 || k_logical > slabs * Kb || G <= 0 || Kb % G || (bits != 8 && bits != 16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* sums = static_cast<int*>(xsum);
  return (int)(bits == 8 ? iwoq::rows_slab<1>(x, x_bf16, k_logical, slabs, Kb, G, norm, eps,
                                               xq, sx, sums, M, st)
                         : iwoq::rows_slab<2>(x, x_bf16, k_logical, slabs, Kb, G, norm, eps,
                                               xq, sx, sums, M, st));
}
