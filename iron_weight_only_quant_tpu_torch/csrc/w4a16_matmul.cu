// iwoq_w4a16_matmul: y = sx * (quantize(x) @ dequant(qw)), 4-bit nib4-layout affine weights,
// split-plane 16-bit activations (A16: x ~= sx * (256 * hi + lo), two int8 planes);
// bf16 or f32 x, quantized per row by the row pass of the same call.
// Replaces _int4_kernel_a16 (:418) (_group_accum_a16 :253-286), called at
// :1670, and its stacked form _int4_kernel_a16_pfx (:1722, through :1927) of
// iron_weight_only_quant_tpu/ops/pallas/dequant_matmul.py.
// Bound by bytes at decode: per launch, half a byte per weight + f32 scales
// and zeros + two int8 planes of x + output, over 3.35 TB/s; at prefill M by
// 2 * 2*M*K*N int8 operations over 1,979 TOP/s.
// The design (row pass with per-group activation sums; the low nibbles and
// the MSB-flipped high nibbles as two slabs of K/2 rows; the JAX kernel's
// decode, one mask a word: the low codes w & 0x0F0F0F0F, the high ones w &
// 0xF0F0F0F0 read as int8, i.e. 16 q - 128, whose group epilogue takes s /
// 16 and z - 8; products on the int8 tensor cores by mma.sync m16n8k32, each
// plane's int32 sum turned f32 before the 256 recombination; the block's K
// range split into two parts over its warps; a cp.async ring of weight
// windows; deterministic K-split) is the affine nib4 case of
// wa_slab_mma.cuh.  Kp = K/2, the packed rows; xq is the scratch of
// slab_planes_bytes plus the group sums.
#include "wa_slab_mma.cuh"

extern "C" int iwoq_w4a16_matmul(const void* x, int x_bf16, int k_logical, int norm,
                                 float eps, const void* qw, const void* s, long long s_rs,
                                 long long s_cs, const void* z, long long z_rs,
                                 long long z_cs, void* xq, void* sx, void* ws, void* out,
                                 int M, int N, int n_out, int Kp, int G, int kc, int splits,
                                 void* stream) {
  return iwoq::launch_wa_slab<iwoq::kNib4>(x, x_bf16, k_logical, norm, eps, qw, s, s_rs, s_cs,
                                           z, z_rs, z_cs, xq, sx, ws, out, M, N, n_out, Kp, G,
                                           kc, splits, stream);
}
