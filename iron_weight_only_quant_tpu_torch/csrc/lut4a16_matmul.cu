// iwoq_lut4a16_matmul: y = sx * (quantize(x) @ dequant(qw)), 4-bit minifloat
// codes (fp4 E2M1, E1M2) in the nib4 layout, 16-bit fixed-point activations
// (A16: two int8 planes); bf16 or f32 x, quantized per row by the row pass
// of the same call.
// Replaces _lut4_kernel_a16 (:771) (_lut_accum_a16 :698), called at :1607,
// and its stacked form _lut4_kernel_a16_pfx (:806, through :1927) of
// iron_weight_only_quant_tpu/ops/pallas/dequant_matmul.py.
// Bound by bytes at decode: per launch, half a byte per weight + f32 scales
// [+ zeros] + two int8 planes of x + output, over 3.35 TB/s; at prefill M by
// 2 * 2*M*K*N int8 operations over 1,979 TOP/s.
// The design (row pass, with per-group activation sums only where the
// artifact has zeros; the low and the flipped high nibbles as two slabs;
// codes to their exact int8 grid by two prmt lookups in an eight-byte table
// built per thread and a sign select, four a word; products on the int8
// tensor cores by mma.sync m16n8k32, each plane's int32 sum turned f32
// before the 256 recombination, acc += part * (s * 2^-t) + xsum * z per
// group; a cp.async ring of weight windows; deterministic K-split) is the
// nib4 LUT case of wa_slab_mma.cuh.
#include "wa_slab_mma.cuh"

// Kp is the number of packed rows, K_stored / 2; qw is [Kp, N].
extern "C" int iwoq_lut4a16_matmul(const void* x, int x_bf16, int k_logical, int norm,
                                   float eps, const void* qw, const void* s, long long s_rs,
                                   long long s_cs, const void* z, long long z_rs,
                                   long long z_cs, void* xq, void* sx, void* ws, void* out,
                                   int M, int N, int n_out, int Kp, int G, int kc,
                                   int splits, int exp_bits, int mant_bits, void* stream) {
  return iwoq::launch_wa_slab<iwoq::kLut4>(x, x_bf16, k_logical, norm, eps, qw, s, s_rs,
                                           s_cs, z, z_rs, z_cs, xq, sx, ws, out, M, N, n_out,
                                           Kp, G, kc, splits, stream, exp_bits, mant_bits);
}
