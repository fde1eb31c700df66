// iwoq_w3_matmul: y = x @ dequant(qw), 3-bit s21-layout affine, bf16 or f32 x.
// Replaces _int3_kernel (:467) with bf16/f32 x and its stacked form
// _int3_kernel_pfx (:1360), called through _call_int3 (:1365), of
// iron_weight_only_quant_tpu/ops/pallas/dequant_matmul.py.
// Bound by bytes at decode: per launch, 3/8 byte per weight + f32 scales and
// zeros + x + output, over 3.35 TB/s; at prefill M by 2*M*K*N bf16
// operations over 989 TFLOP/s.
// Two routes, one name and one launch count: bf16 x takes
// iwoq_w3_matmul_mma, the s21 case of the bf16 family of wa_slab_mma.cuh
// (each slab's codes f + 4h assembled from the A and B rows, made exact bf16
// by a byte permute under the exponent of 128 and one bf16x2 subtraction,
// bf16 products on the tensor cores by mma.sync m16n8k16 with f32 sums, acc
// += part * s - xsum * (s * z) per group with the group sums of x taken in
// the kernel, a cp.async ring, a row pass only for a pre-norm or an x it
// cannot read in place); f32 x takes iwoq_w3_matmul, w3_common.cuh's
// CUDA-core kernel (one warp per K slab, exact decode in registers, one read
// of each weight byte from device memory per row tile, deterministic
// K-split).  The CUDA-core entry point has W4's signature (rnorm and eps
// unused: no prenorm form; x is normalized first), with Kp = Kb, the B rows.
#include "w3_common.cuh"
#include "wa_slab_mma.cuh"

// x is [M, ldx] with ldx = 8 * Kb (the K padding already appended).
extern "C" int iwoq_w3_matmul(const void* x, int x_bf16, int ldx, const void* qw,
                              const void* s, long long s_rs, long long s_cs,
                              const void* z, long long z_rs, long long z_cs,
                              void* ws, void* rnorm, void* out, int M, int N,
                              int n_out, int Kb, int G, int kc, int splits,
                              int k_logical, float eps, void* stream) {
  (void)rnorm;
  (void)k_logical;
  (void)eps;
  if (M <= 0 || N <= 0 || N % iwoq::kColsPerThread || n_out > N || Kb <= 0 || G <= 0 ||
      Kb % G || kc <= 0 || splits <= 0 || (long long)kc * splits < Kb ||
      (long long)ldx != 8LL * Kb)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      x_bf16 ? iwoq::launch_w3_typed<__nv_bfloat16>(x, ldx, qw, s, s_rs, s_cs, z, z_rs, z_cs,
                                                    ws, out, M, N, n_out, Kb, G, kc, splits, st)
             : iwoq::launch_w3_typed<float>(x, ldx, qw, s, s_rs, s_cs, z, z_rs, z_cs, ws, out,
                                            M, N, n_out, Kb, G, kc, splits, st);
  return (int)err;
}

// bf16 x [M, 8 Kb]; qw is [3 Kb, N]; exp_bits and mant_bits must be 0 (the
// bf16 family's signature; s21 codes are integers).
extern "C" int iwoq_w3_matmul_mma(const void* x, int ldx, int x_copy, int k_logical, int norm,
                                  float eps, const void* qw, const void* s, long long s_rs,
                                  long long s_cs, const void* z, long long z_rs, long long z_cs,
                                  void* xs, void* ws, void* out, int M, int N, int n_out, int Kb,
                                  int G, int kc, int splits, int exp_bits, int mant_bits,
                                  void* stream) {
  return iwoq::launch_bf16_mma<iwoq::kS21B>(x, ldx, x_copy, k_logical, norm, eps, qw, s, s_rs,
                                            s_cs, z, z_rs, z_cs, xs, ws, out, M, N, n_out, Kb,
                                            G, kc, splits, exp_bits, mant_bits, stream);
}
