// iwoq_w8_matmul_prenorm: y = rsqrt(mean(x^2) + eps) * (x @ dequant(qw)),
// 8-bit byte-layout affine with the weightless RMSNorm of the folded-gamma path.
// Replaces _int8_kernel_prenorm (:380) and _int8_kernel_prenorm_pfx (:413)
// of iron_weight_only_quant_tpu/ops/pallas/dequant_matmul.py.
// Bound by bytes at decode: per launch, one byte per weight + f32 scales and
// zeros + x + output, over 3.35 TB/s; at prefill M by 2*M*K*N bf16
// operations over 989 TFLOP/s.
// Two routes, one name and one launch count: bf16 x takes
// iwoq_w8_matmul_prenorm_mma, the affine byte case (kByteB) of the bf16
// family of wa_slab_mma.cuh with its epilogue norm: the product kernel reads
// the raw x in place (no normalized copy), sums x^2 of the rows it stages
// beside its sums of x, and multiplies the f32 accumulator by r = rsqrt(sum
// / K_logical + eps) before the cast, as _int8_kernel_prenorm does; with a
// K-split it writes its split's sums of x^2 and the reduce finishes r.  f32
// x, and bf16 x whose shape that family does not take, take
// iwoq_w8_matmul_prenorm, w8_common.cuh's CUDA-core kernel (the norm adds
// one pass over x per row tile).
#include "w8_common.cuh"
#include "wa_slab_mma.cuh"

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

// K is the stored rows (one a K column); qw is [K, N]; x is bf16 [M, K];
// norm must be 1; ws holds [splits, M, N] and then [splits, M] f32;
// exp_bits, mant_bits 0 (the bf16 family's signature).
extern "C" int iwoq_w8_matmul_prenorm_mma(const void* x, int ldx, int x_copy, int k_logical,
                                          int norm, float eps, const void* qw, const void* s,
                                          long long s_rs, long long s_cs, const void* z,
                                          long long z_rs, long long z_cs, void* xs, void* ws,
                                          void* out, int M, int N, int n_out, int K, int G,
                                          int kc, int splits, int exp_bits, int mant_bits,
                                          void* stream) {
  return iwoq::launch_bf16_mma<iwoq::kByteB, true>(x, ldx, x_copy, k_logical, norm, eps, qw, s,
                                                   s_rs, s_cs, z, z_rs, z_cs, xs, ws, out, M, N,
                                                   n_out, K, G, kc, splits, exp_bits, mant_bits,
                                                   stream);
}
