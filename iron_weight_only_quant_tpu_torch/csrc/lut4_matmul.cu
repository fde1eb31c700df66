// iwoq_lut4_matmul: y = x @ dequant(qw), 4-bit minifloat codes (fp4 E2M1,
// E1M2) in the nib4 layout, w = val(code) * s (+ z), bf16 or f32 x.
// Replaces _lut4_kernel (:739), called at :1618, and its stacked form
// _lut4_kernel_pfx (:1732, through :1927) of
// iron_weight_only_quant_tpu/ops/pallas/dequant_matmul.py.
// Bound by bytes at decode: per launch, half a byte per weight + f32 scales
// [+ zeros] + x + output, over 3.35 TB/s.  The design (a 16-entry table
// filled by bit assembly from exp_bits/mant_bits, W4's grid and
// deterministic K-split, the zero added per group) is described in
// lut_common.cuh.
#include "lut_common.cuh"

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
