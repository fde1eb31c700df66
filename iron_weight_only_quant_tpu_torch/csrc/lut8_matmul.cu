// iwoq_lut8_matmul: y = x @ dequant(qw), byte minifloat codes (fp8 E4M3,
// E3M4, E2M5; the byte-per-code fp6) stored as code - 128,
// w = val(code) * s (+ z), bf16 or f32 x.
// Replaces _lut8_kernel (:811), called at :1628, and its stacked form
// _lut8_kernel_pfx (:1737, through :1927) of
// iron_weight_only_quant_tpu/ops/pallas/dequant_matmul.py.
// Bound by bytes at decode: per launch, one byte per weight + f32 scales
// [+ zeros] + x + output, over 3.35 TB/s; at prefill M by 2*M*K*N bf16
// operations over 989 TFLOP/s.
// Two routes, one name and one launch count: bf16 x takes
// iwoq_lut8_matmul_mma, the byte LUT case (kLut8B) of the bf16 family of
// wa_slab_mma.cuh (the stored byte XORed with 0x80 back to the code, decoded
// to its exact bf16 value from exp_bits/mant_bits, bf16 products on the
// tensor cores by mma.sync m16n8k16 with f32 sums, acc += part * s + xsum *
// z per group, a cp.async ring, a row pass only for a pre-norm or an x it
// cannot read in place); f32 x, and bf16 x whose shape that family does not
// take (the byte-per-code fp6, whose K is no multiple of 4), take
// iwoq_lut8_matmul, lut_common.cuh's CUDA-core kernel (a 256-entry table
// indexed by the stored byte, filled by bit assembly from
// exp_bits/mant_bits, W8's grid and deterministic K-split, the zero added
// per group).
#include "lut_common.cuh"
#include "wa_slab_mma.cuh"

extern "C" int iwoq_lut8_matmul(const void* x, int x_bf16, int ldx, const void* qw,
                                const void* s, long long s_rs, long long s_cs,
                                const void* z, long long z_rs, long long z_cs,
                                void* ws, void* out, int M, int N, int n_out, int Kp,
                                int G, int kc, int splits, int exp_bits, int mant_bits,
                                void* stream) {
  return iwoq::launch_lut<1>(x, x_bf16, ldx, qw, s, s_rs, s_cs, z, z_rs, z_cs, ws,
                                 out, M, N, n_out, Kp, G, kc, splits, exp_bits,
                                 mant_bits, stream);
}

// K is the stored rows (one a K column); qw is [K, N]; x is bf16 [M, K].
extern "C" int iwoq_lut8_matmul_mma(const void* x, int ldx, int x_copy, int k_logical, int norm,
                                    float eps, const void* qw, const void* s, long long s_rs,
                                    long long s_cs, const void* z, long long z_rs,
                                    long long z_cs, void* xs, void* ws, void* out, int M, int N,
                                    int n_out, int K, int G, int kc, int splits, int exp_bits,
                                    int mant_bits, void* stream) {
  return iwoq::launch_bf16_mma<iwoq::kLut8B>(x, ldx, x_copy, k_logical, norm, eps, qw, s, s_rs,
                                             s_cs, z, z_rs, z_cs, xs, ws, out, M, N, n_out, K,
                                             G, kc, splits, exp_bits, mant_bits, stream);
}
