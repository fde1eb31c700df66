// iwoq_lut6a16_matmul: y = sx * (quantize(x) @ dequant(qw)), 6-bit minifloat
// codes (fp6 E2M3, or E1M4) in the nq42 layout, 16-bit fixed-point
// activations (A16: two int8 planes); bf16 or f32 x, quantized per row by
// the row pass of the same call.
// Replaces _lut6_kernel_a16 (:892) and its stacked form _lut6_kernel_a16_pfx
// (:934), both through _call_lut6 (:939, called at :1575 and :1798), of
// iron_weight_only_quant_tpu/ops/pallas/dequant_matmul.py.
// Bound by bytes at decode: per launch, three quarters of a byte per weight
// + f32 scales [+ zeros] + two int8 planes of x + output, over 3.35 TB/s; at
// prefill M by 2 * 2*M*K*N int8 operations over 1,979 TOP/s.
// The design (row pass, with per-group activation sums only where the
// artifact has zeros; codes to their exact int8 grid by arithmetic on the
// exponent and mantissa fields, four a word; products on the int8 tensor
// cores by mma.sync m16n8k32, each plane's int32 sum turned f32 before the
// 256 recombination, acc += part * (s * 2^-t) + xsum * z per group; a
// cp.async ring of weight windows; deterministic K-split) is the nq42 case
// of wa_slab_mma.cuh.
#include "wa_slab_mma.cuh"

// Kp is the number of quad rows, K_stored / 4; qw is [3 Kp, N].
extern "C" int iwoq_lut6a16_matmul(const void* x, int x_bf16, int k_logical, int norm,
                                   float eps, const void* qw, const void* s, long long s_rs,
                                   long long s_cs, const void* z, long long z_rs,
                                   long long z_cs, void* xq, void* sx, void* ws, void* out,
                                   int M, int N, int n_out, int Kp, int G, int kc,
                                   int splits, int exp_bits, int mant_bits, void* stream) {
  return iwoq::launch_wa_slab<iwoq::kLut6>(x, x_bf16, k_logical, norm, eps, qw, s, s_rs,
                                           s_cs, z, z_rs, z_cs, xq, sx, ws, out, M, N, n_out,
                                           Kp, G, kc, splits, stream, exp_bits, mant_bits);
}
