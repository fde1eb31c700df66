// The packed weight layouts and the tiles of the slab kernel
// (wa_slab_mma.cuh), in plain C++ (no CUDA headers), so that a host
// compiler can print the tile constants: tests/test_torch_w4a16_w3_mma.py
// holds dequant_matmul.SLAB_TILES in ops/kernels/ to them.
#pragma once

namespace iwoq {

// packed weight layouts: nib4 (int4, bfp4), byte (int8, bfp8), s21 (3-bit)
// affine; the nib4 (fp4) and nq42 (fp6) LUT layouts; kLut4B, kLut6B, kS21B,
// kNib4B, kByteB and kLut8B are the nib4 LUT, nq42 LUT, s21, affine nib4,
// affine byte and byte LUT (fp8) layouts with bf16 activations and bf16
// products (the slab kernel's bf16 family); kNib4M and kNib4T are the two
// decodes of the W4 inner-loop probe on the affine nib4 packing, bf16 x:
// "magic" (codes left as bf16(128 + q), the 128 folded into the zero
// point; bf16 products) and "f32" (codes converted to f32, TF32 products)
enum Layout {
  kNib4 = 0, kByte = 1, kS21 = 2, kLut4 = 3, kLut6 = 4, kLut4B = 5, kLut6B = 6, kS21B = 7,
  kNib4B = 8, kByteB = 9, kLut8B = 10, kNib4M = 11, kNib4T = 12
};

constexpr int kSlabWin = 32;  // slab rows a window: one int8 MMA's K

// The tile of one (LAYOUT, NT) instantiation of the slab kernel.  A layout
// is S slabs of Kb rows; a window copies A packed arrays (s21, nq42: three)
// or P parts of the block's range (byte, nib4: one array).  A warp takes CT
// 16-channel MMA tiles of SW slabs of one part (W = CT / 2 packed words a
// row a lane); WS warps split a group's channels, so a block covers BN = 16
// * CT * WS channels.  Eight warps a block.  Decode (NT = 1): 4 tiles a warp
// (the nib4 tiles, affine and LUT, two slabs a warp: 2), BN = 64 (s21) or
// 128, two blocks an SM (each barrier stalls only its own block); wider
// token tiles: one block an SM (their accumulators need more registers a
// thread; all but s21 then take 2 tiles a warp, BN = 64).  The bf16 family
// (kLut4B, kLut6B, kS21B, kNib4B, kByteB, kLut8B, and the probe's kNib4M,
// kNib4T) has the decode tile of its packed layout and one wide tile, the
// warps of a slab each their own channels, P = 1, so a block decodes each
// weight once: NT = 8 (64 tokens)
// with 2 tiles a warp (BN = 128 nib4, LUT and affine, 64 nq42, 256 byte:
// its one slab takes all eight warps, and the split plan's K-split fills
// the SMs where N leaves too few blocks; on the H100 this beat four warps a
// part, P = 2, BN = 128, at every prefill row count from 128 up), and for
// s21, whose eight slabs leave one warp a slab, NT = 4 (32 tokens) with 4
// tiles a warp (BN = 64: a 64-token tile would need 256 accumulator
// registers a thread).
template <int LAYOUT, int NT>
struct SlabTile {
  static constexpr bool BF = LAYOUT == kLut4B || LAYOUT == kLut6B || LAYOUT == kS21B ||
                             LAYOUT == kNib4B || LAYOUT == kByteB || LAYOUT == kLut8B ||
                             LAYOUT == kNib4M || LAYOUT == kNib4T;
  static constexpr int L = LAYOUT == kLut4B ? kLut4   // the packing
                         : LAYOUT == kLut6B ? kLut6
                         : LAYOUT == kS21B ? kS21
                         : LAYOUT == kNib4B || LAYOUT == kNib4M || LAYOUT == kNib4T ? kNib4
                         : LAYOUT == kByteB || LAYOUT == kLut8B ? kByte : LAYOUT;
  static constexpr int S = L == kS21 ? 8 : L == kLut6 ? 4 : L == kLut4 || L == kNib4 ? 2 : 1;
  static constexpr int A = L == kS21 || L == kLut6 ? 3 : 1;  // packed arrays
  static constexpr int WARPS = 8;
  static constexpr int BLOCKS_PER_SM = NT == 1 ? 2 : 1;
  static constexpr int THREADS = WARPS * 32;
  // slabs a warp decodes from one staged word: the nib4 decode tiles take
  // both nibbles of a byte at once (one load, one transpose)
  static constexpr int SW = (L == kLut4 || L == kNib4) && NT == 1 ? 2 : 1;
  // warps a group
  static constexpr int WS = BF && NT > 1 ? WARPS / S : L == kS21 ? 1 : SW == 2 ? 4 : 2;
  static constexpr int P = WARPS / (S / SW * WS);        // parts of the block's K range
  static constexpr int V = S / SW * P;                   // groups: SW slabs of a part
  static constexpr int CT = L == kS21 || (NT == 1 && SW == 1) ? 4 : 2;  // MMA channel tiles a warp
  static constexpr int W = CT / 2;                       // packed words a lane reads a row
  static constexpr int BN = 16 * CT * WS;                // channels a block
  static constexpr int MT = 8 * NT;                      // tokens a block
  static constexpr int STAGES = 4;                       // windows in the ring
  // Words a staged row, padded so that rows 4i + t (t = 0..3) start 0,
  // 24, 16 and 8 banks apart (BN / 4 is 16 or 32).
  static constexpr int PITCH = BN / 4 + 8;
  static constexpr int W_BYTES = A * P * kSlabWin * PITCH * 4;  // [array or part][32 rows]
  // int8 [part][slab][plane][token][32]; bf16 [part][slab][token][32] of 2 bytes
  static constexpr int X_BYTES = S * P * 2 * MT * kSlabWin;
  static constexpr int STAGE = W_BYTES + X_BYTES;
  static constexpr int RED = V * MT * (BN + 1) * 4;            // f32 [group][token][BN + 1]
  static constexpr int SMEM = STAGES * STAGE > RED ? STAGES * STAGE : RED;
  static_assert(V * WS == WARPS && (A == 1 || P == 1), "warps over slabs, parts, channels");
  static_assert(W == 1 || W == 2, "one 32- or 64-bit load a row");
  static_assert((PITCH * 4) % 16 == 0 && ((BN / 4) % 16 == 0), "16-byte rows, bank steps");
  static_assert(BLOCKS_PER_SM * (SMEM + 1024) <= 228 * 1024, "the blocks of an SM");
};

// The token tile NT (8 NT tokens a block) of the slab kernel for M
// activation rows and `planes` int8 activation planes (A16: 2, A8: 1; the
// bf16 family: any): the decode tile at M <= 8, else the layout's wide
// tile.  One plane (A8) halves the s32 accumulators and B fragments, so it
// takes twice the tokens of two: the affine nib4 (w4a8) and byte (w8a8)
// layouts 64 (on the H100 64 tokens beat 32 at every prefill row count
// from 64 up, spills and all), s21 (w3a8) 32.
constexpr int slab_tile_nt(int M, int layout, int planes = 2) {
  return M <= 8 ? 1
         : layout == kS21 ? (planes == 1 ? 4 : 2)
         : layout == kLut4B || layout == kLut6B || layout == kNib4B || layout == kByteB ||
                   layout == kLut8B || layout == kNib4M || layout == kNib4T ||
                   ((layout == kNib4 || layout == kByte) && planes == 1)
               ? 8 : 4;
}

}  // namespace iwoq
