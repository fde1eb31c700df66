// iwoq_lut8_matmul: y = x @ dequant(qw), byte minifloat codes (fp8 E4M3,
// E3M4, E2M5; the byte-per-code fp6) stored as code - 128,
// w = val(code) * s (+ z), bf16 or f32 x.
// Replaces _lut8_kernel (:811), called at :1628, and its stacked form
// _lut8_kernel_pfx (:1737, through :1927) of
// iron_weight_only_quant_tpu/ops/pallas/dequant_matmul.py.
// Bound by bytes at decode: per launch, one byte per weight + f32 scales
// [+ zeros] + x + output, over 3.35 TB/s.  The design (a 256-entry table
// indexed by the stored byte, filled by bit assembly from
// exp_bits/mant_bits, W8's grid and deterministic K-split, the zero added
// per group) is described in lut_common.cuh.
#include "lut_common.cuh"

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
