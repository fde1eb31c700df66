// iwoq_lut6_matmul: y = x @ dequant(qw), 6-bit minifloat codes (fp6 E2M3,
// E3M2) in the nq42 layout, w = val(code) * s (+ z), bf16 or f32 x.
// Replaces _lut6_kernel (:835) and its stacked form _lut6_kernel_pfx
// (:887), both through _call_lut6 (:939, called at :1575 and :1798), of
// iron_weight_only_quant_tpu/ops/pallas/dequant_matmul.py.
// Bound by bytes at decode: per launch, three quarters of a byte per weight
// + f32 scales [+ zeros] + x + output, over 3.35 TB/s; at prefill M by
// 2*M*K*N bf16 operations over 989 TFLOP/s.
// Two routes, one name and one launch count: bf16 x takes
// iwoq_lut6_matmul_mma, the nq42 case of the bf16 family of
// wa_slab_mma.cuh (the quarter's codes assembled from the nibble and quad
// rows, decoded to their exact bf16 values from exp_bits/mant_bits, bf16
// products on the tensor cores by mma.sync m16n8k16 with f32 sums, acc +=
// part * s + xsum * z per group, a cp.async ring, a row pass only for zeros
// or a pre-norm); f32 x takes iwoq_lut6_matmul, lut_common.cuh's CUDA-core
// kernel (three 32-bit loads per quad row, a 64-entry table filled by bit
// assembly, W4's grid and deterministic K-split, the zero added per group).
#include "lut_common.cuh"
#include "wa_slab_mma.cuh"

// Kp is the number of quad rows, K_stored / 4; qw is [3 Kp, N].
extern "C" int iwoq_lut6_matmul(const void* x, int x_bf16, int ldx, const void* qw,
                                const void* s, long long s_rs, long long s_cs,
                                const void* z, long long z_rs, long long z_cs,
                                void* ws, void* out, int M, int N, int n_out, int Kp,
                                int G, int kc, int splits, int exp_bits, int mant_bits,
                                void* stream) {
  return iwoq::launch_lut<4>(x, x_bf16, ldx, qw, s, s_rs, s_cs, z, z_rs, z_cs, ws,
                             out, M, N, n_out, Kp, G, kc, splits, exp_bits,
                             mant_bits, stream);
}

// x is bf16 [M, 4 Kp].
extern "C" int iwoq_lut6_matmul_mma(const void* x, int ldx, int x_copy, int k_logical, int norm,
                                    float eps, const void* qw, const void* s, long long s_rs,
                                    long long s_cs, const void* z, long long z_rs,
                                    long long z_cs, void* xs, void* ws, void* out, int M, int N,
                                    int n_out, int Kp, int G, int kc, int splits, int exp_bits,
                                    int mant_bits, void* stream) {
  return iwoq::launch_bf16_mma<iwoq::kLut6B>(x, ldx, x_copy, k_logical, norm, eps, qw, s, s_rs,
                                             s_cs, z, z_rs, z_cs, xs, ws, out, M, N, n_out, Kp,
                                             G, kc, splits, exp_bits, mant_bits, stream);
}
