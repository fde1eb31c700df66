// iwoq_w4a8_matmul: y = sx * (quantize(x) @ dequant(qw)), 4-bit nib4-layout affine weights,
// int8 activations (A8: one plane);
// bf16 or f32 x, quantized per row by the row pass of the same call.
// Replaces _int4_kernel (:319) with int8 x (the int path of _group_accum :226-249),
// called at :1680, and its stacked form _int4_kernel_pfx (:1712)
// of iron_weight_only_quant_tpu/ops/pallas/dequant_matmul.py.
// Bound by bytes at decode: per launch, half a byte per weight + f32 scales
// and zeros + int8 x + output, over 3.35 TB/s; at prefill M by 2*M*K*N int8
// operations over 1,979 TOP/s.
// The design is w4a16's (the affine nib4 case of wa_slab_mma.cuh: the low
// nibbles and the MSB-flipped high nibbles as two slabs of K/2 rows, the
// JAX kernel's decode, the low codes w & 0x0F0F0F0F and the high ones w &
// 0xF0F0F0F0 read as int8, 16 q - 128, whose group epilogue takes s / 16
// and z - 8; products on the int8 tensor cores by mma.sync m16n8k32; the
// group sums of the codes in the row pass; a cp.async ring; deterministic
// K-split) with one plane: the row pass writes the A8 codes
// (sx = max|x| / 127, q = clip(rint(x / sx), +-127)) and their
// plain group sums, and the product kernel stages and multiplies that one
// plane, part = pa.  Kp = K/2, the packed rows; xq is the scratch of
// slab_planes_bytes (one plane) plus the group sums.
#include "wa_slab_mma.cuh"

extern "C" int iwoq_w4a8_matmul(const void* x, int x_bf16, int k_logical, int norm,
                                float eps, const void* qw, const void* s, long long s_rs,
                                long long s_cs, const void* z, long long z_rs,
                                long long z_cs, void* xq, void* sx, void* ws, void* out,
                                int M, int N, int n_out, int Kp, int G, int kc, int splits,
                                void* stream) {
  return iwoq::launch_wa_slab<iwoq::kNib4, 1>(x, x_bf16, k_logical, norm, eps, qw, s, s_rs,
                                              s_cs, z, z_rs, z_cs, xq, sx, ws, out, M, N, n_out,
                                              Kp, G, kc, splits, stream);
}
