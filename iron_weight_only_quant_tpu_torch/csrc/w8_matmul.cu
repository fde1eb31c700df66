// iwoq_w8_matmul: y = x @ dequant(qw), 8-bit byte-layout affine, bf16 or f32 x.
// Replaces _int8_kernel (:1057, body _int8_body :1040) and its stacked form
// _int8_kernel_pfx (:1717) of iron_weight_only_quant_tpu/ops/pallas/dequant_matmul.py.
// Bound by bytes at decode: per launch, one byte per weight + f32 scales and
// zeros + x + output, over 3.35 TB/s; at prefill M by 2*M*K*N bf16
// operations over 989 TFLOP/s.
// Two routes, one name and one launch count: bf16 x takes
// iwoq_w8_matmul_mma, the affine byte case (kByteB) of the bf16 family of
// wa_slab_mma.cuh (the stored byte read as int8 made exact bf16 by two byte
// permutes under the exponent bytes of 128 and -128 and one bf16x2 fma;
// bf16 products on the tensor cores by mma.sync m16n8k16 with f32 sums, acc
// += part * s - xsum * (s * z) per group with the group sums of x taken in
// the kernel, a cp.async ring, one kernel a call, or two with a K-split);
// f32 x, and bf16 x whose shape that family does not take, take
// iwoq_w8_matmul, w8_common.cuh's CUDA-core kernel (one read of each weight
// byte per row tile, decoded in registers, deterministic K-split).  The
// prenorm form, w8_matmul_prenorm, takes the same two routes.
#include "w8_common.cuh"
#include "wa_slab_mma.cuh"

extern "C" int iwoq_w8_matmul(const void* x, int x_bf16, int ldx, const void* qw,
                              const void* s, long long s_rs, long long s_cs,
                              const void* z, long long z_rs, long long z_cs,
                              void* ws, void* rnorm, void* out, int M, int N,
                              int n_out, int K, int G, int kc, int splits,
                              int k_logical, float eps, void* stream) {
  return iwoq::launch_w8<false>(x, x_bf16, ldx, qw, s, s_rs, s_cs, z, z_rs, z_cs,
                                ws, rnorm, out, M, N, n_out, K, G, kc, splits,
                                k_logical, eps, stream);
}

// K is the stored rows (one a K column); qw is [K, N]; x is bf16 [M, K];
// norm must be 0 and exp_bits, mant_bits 0 (the bf16 family's signature).
extern "C" int iwoq_w8_matmul_mma(const void* x, int ldx, int x_copy, int k_logical, int norm,
                                  float eps, const void* qw, const void* s, long long s_rs,
                                  long long s_cs, const void* z, long long z_rs, long long z_cs,
                                  void* xs, void* ws, void* out, int M, int N, int n_out, int K,
                                  int G, int kc, int splits, int exp_bits, int mant_bits,
                                  void* stream) {
  return iwoq::launch_bf16_mma<iwoq::kByteB>(x, ldx, x_copy, k_logical, norm, eps, qw, s, s_rs,
                                             s_cs, z, z_rs, z_cs, xs, ws, out, M, N, n_out, K,
                                             G, kc, splits, exp_bits, mant_bits, stream);
}
