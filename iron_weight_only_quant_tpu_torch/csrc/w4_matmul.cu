// iwoq_w4_matmul: y = x @ dequant(qw), W4 affine, bf16 or f32 x.
// Replaces _int4_kernel (:319) and its stacked form _int4_kernel_pfx (:1712)
// of iron_weight_only_quant_tpu/ops/pallas/dequant_matmul.py.
// Bound by bytes at decode: per launch, packed weights + f32 scales and
// zeros + x + output, over 3.35 TB/s.  The design that answers it (one
// read of each weight byte per row tile, decoded in registers, deterministic
// K-split) is described in w4_common.cuh.
#include "w4_common.cuh"

extern "C" int iwoq_w4_matmul(const void* x, int x_bf16, int ldx, const void* qw,
                          const void* s, long long s_rs, long long s_cs,
                          const void* z, long long z_rs, long long z_cs,
                          void* ws, void* rnorm, void* out, int M, int N,
                          int n_out, int Kp, int G, int kc, int splits,
                          int k_logical, float eps, void* stream) {
  return iwoq::launch<false>(x, x_bf16, ldx, qw, s, s_rs, s_cs, z, z_rs, z_cs,
                             ws, rnorm, out, M, N, n_out, Kp, G, kc, splits,
                             k_logical, eps, stream);
}
