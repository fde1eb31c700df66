// iwoq_w8a8_matmul: y = sx * (quantize(x) @ dequant(qw)), 8-bit byte-layout affine weights,
// int8 activations (A8: one plane);
// bf16 or f32 x, quantized per row by the row pass of the same call.
// Replaces _int8_kernel (:1057, body _int8_body :1040) with int8 x, called at :1700,
// and its stacked form _int8_kernel_pfx (:1717)
// of iron_weight_only_quant_tpu/ops/pallas/dequant_matmul.py.
// Bound by bytes at decode: per launch, one byte per weight + f32 scales and
// zeros + int8 x + output, over 3.35 TB/s; at prefill M by 2*M*K*N int8
// operations over 1,979 TOP/s.
// The design is w8a16's (the byte case of wa_slab_mma.cuh: the stored bytes,
// read as int8, are the A operand as they are, no decode; products on the
// int8 tensor cores by mma.sync m16n8k32; the group sums of the codes in the
// row pass; the block's K range split into four parts over its warps; a
// cp.async ring; deterministic K-split) with one plane: the row pass writes
// the A8 codes (sx = max|x| / 127, q = clip(rint(x / sx), +-127)) and their
// plain group sums, and the product kernel stages and multiplies that one
// plane, part = pa.  Kp = K, the packed rows; xq is the scratch of
// slab_planes_bytes (one plane) plus the group sums.
#include "wa_slab_mma.cuh"

extern "C" int iwoq_w8a8_matmul(const void* x, int x_bf16, int k_logical, int norm,
                                float eps, const void* qw, const void* s, long long s_rs,
                                long long s_cs, const void* z, long long z_rs,
                                long long z_cs, void* xq, void* sx, void* ws, void* out,
                                int M, int N, int n_out, int Kp, int G, int kc, int splits,
                                void* stream) {
  return iwoq::launch_wa_slab<iwoq::kByte, 1>(x, x_bf16, k_logical, norm, eps, qw, s, s_rs,
                                              s_cs, z, z_rs, z_cs, xq, sx, ws, out, M, N, n_out,
                                              Kp, G, kc, splits, stream);
}
