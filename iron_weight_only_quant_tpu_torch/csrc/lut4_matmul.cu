// iwoq_lut4_matmul: y = x @ dequant(qw), 4-bit minifloat codes (fp4 E2M1,
// E1M2) in the nib4 layout, w = val(code) * s (+ z), bf16 or f32 x.
// Replaces _lut4_kernel (:739), called at :1618, and its stacked form
// _lut4_kernel_pfx (:1732, through :1927) of
// iron_weight_only_quant_tpu/ops/pallas/dequant_matmul.py.
// Bound by bytes at decode: per launch, half a byte per weight + f32 scales
// [+ zeros] + x + output, over 3.35 TB/s; at prefill M by 2*M*K*N bf16
// operations over 989 TFLOP/s.
// Two routes, one name and one launch count: bf16 x takes
// iwoq_lut4_matmul_mma, the nib4 case of the bf16 family of
// wa_slab_mma.cuh (codes to their exact bf16 values, bf16 products on the
// tensor cores by mma.sync m16n8k16 with f32 sums, acc += part * s + xsum *
// z per group, a cp.async ring, a row pass only for zeros or a pre-norm);
// f32 x takes iwoq_lut4_matmul, lut_common.cuh's CUDA-core kernel (a
// 16-entry table filled by bit assembly from exp_bits/mant_bits, W4's grid
// and deterministic K-split, the zero added per group).
#include "lut_common.cuh"
#include "wa_slab_mma.cuh"

extern "C" int iwoq_lut4_matmul(const void* x, int x_bf16, int ldx, const void* qw,
                                const void* s, long long s_rs, long long s_cs,
                                const void* z, long long z_rs, long long z_cs,
                                void* ws, void* out, int M, int N, int n_out, int Kp,
                                int G, int kc, int splits, int exp_bits, int mant_bits,
                                void* stream) {
  return iwoq::launch_lut<2>(x, x_bf16, ldx, qw, s, s_rs, s_cs, z, z_rs, z_cs, ws,
                                out, M, N, n_out, Kp, G, kc, splits, exp_bits,
                                mant_bits, stream);
}

// Kp is the number of packed rows, K_stored / 2; qw is [Kp, N]; x is bf16
// [M, 2 Kp].
extern "C" int iwoq_lut4_matmul_mma(const void* x, int ldx, int x_copy, int k_logical, int norm,
                                    float eps, const void* qw, const void* s, long long s_rs,
                                    long long s_cs, const void* z, long long z_rs,
                                    long long z_cs, void* xs, void* ws, void* out, int M, int N,
                                    int n_out, int Kp, int G, int kc, int splits, int exp_bits,
                                    int mant_bits, void* stream) {
  return iwoq::launch_bf16_mma<iwoq::kLut4B>(x, ldx, x_copy, k_logical, norm, eps, qw, s, s_rs,
                                             s_cs, z, z_rs, z_cs, xs, ws, out, M, N, n_out, Kp,
                                             G, kc, splits, exp_bits, mant_bits, stream);
}
