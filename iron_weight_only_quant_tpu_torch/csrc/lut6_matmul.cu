// iwoq_lut6_matmul: y = x @ dequant(qw), 6-bit minifloat codes (fp6 E2M3,
// E3M2) in the nq42 layout, w = val(code) * s (+ z), bf16 or f32 x.
// Replaces _lut6_kernel (:835) and its stacked form _lut6_kernel_pfx
// (:887), both through _call_lut6 (:939, called at :1575 and :1798), of
// iron_weight_only_quant_tpu/ops/pallas/dequant_matmul.py.
// Bound by bytes at decode: per launch, three quarters of a byte per weight
// + f32 scales [+ zeros] + x + output, over 3.35 TB/s.  The design (three
// 32-bit loads per quad row for the 16 codes of four columns in the four K
// quarters, four x slabs staged in shared memory, a 64-entry table filled by
// bit assembly from exp_bits/mant_bits, W4's grid and deterministic K-split,
// the zero added per group) is described in lut_common.cuh.
#include "lut_common.cuh"

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
