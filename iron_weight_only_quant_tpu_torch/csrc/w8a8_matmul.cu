// iwoq_w8a8_matmul: y = sx * (quantize(x) @ dequant(qw)), 8-bit byte-layout affine weights,
// int8 activations (A8: one plane);
// bf16 or f32 x, quantized per row by the row pass of the same call.
// Replaces _int8_kernel (:1057, body _int8_body :1040) with int8 x, called at :1700,
// and its stacked form _int8_kernel_pfx (:1717)
// of iron_weight_only_quant_tpu/ops/pallas/dequant_matmul.py.
// Bound by bytes at decode: per launch, one byte per weight + f32 scales and
// zeros + int8 x + output, over 3.35 TB/s; at prefill M by 2*M*K*N int8
// operations over 1,979 TOP/s.
// The design (row pass, __dp4a over the int8 planes, one read of each weight
// byte per row tile, deterministic K-split) is described in wa_common.cuh.
#include "wa_common.cuh"

extern "C" int iwoq_w8a8_matmul(const void* x, int x_bf16, int k_logical, int norm,
                       float eps, const void* qw, const void* s, long long s_rs,
                       long long s_cs, const void* z, long long z_rs,
                       long long z_cs, void* xq, void* sx, void* ws, void* out,
                       int M, int N, int n_out, int Kp, int G, int kc, int splits,
                       void* stream) {
  return iwoq::launch_wa<iwoq::kByte>(x, x_bf16, k_logical, norm, eps, qw, s, s_rs, s_cs,
                                         z, z_rs, z_cs, xq, sx, ws, out, M, N, n_out, Kp,
                                         G, kc, splits, stream);
}
