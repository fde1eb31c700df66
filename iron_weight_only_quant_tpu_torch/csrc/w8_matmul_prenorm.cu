// iwoq_w8_matmul_prenorm: y = rsqrt(mean(x^2) + eps) * (x @ dequant(qw)),
// 8-bit byte-layout affine with the weightless RMSNorm of the folded-gamma path.
// Replaces _int8_kernel_prenorm (:380) and _int8_kernel_prenorm_pfx (:413)
// of iron_weight_only_quant_tpu/ops/pallas/dequant_matmul.py.
// Bound by bytes at decode: per launch, one byte per weight + f32 scales and
// zeros + x + output, over 3.35 TB/s.  The design that answers it is
// described in w8_common.cuh; the norm adds one pass over x per row tile.
#include "w8_common.cuh"

extern "C" int iwoq_w8_matmul_prenorm(const void* x, int x_bf16, int ldx, const void* qw,
                                      const void* s, long long s_rs, long long s_cs,
                                      const void* z, long long z_rs, long long z_cs,
                                      void* ws, void* rnorm, void* out, int M, int N,
                                      int n_out, int K, int G, int kc, int splits,
                                      int k_logical, float eps, void* stream) {
  return iwoq::launch_w8<true>(x, x_bf16, ldx, qw, s, s_rs, s_cs, z, z_rs, z_cs,
                               ws, rnorm, out, M, N, n_out, K, G, kc, splits,
                               k_logical, eps, stream);
}
