// iwoq_w3a8_matmul: y = sx * (quantize(x) @ dequant(qw)), 3-bit s21-layout affine weights,
// int8 activations (A8: one plane);
// bf16 or f32 x, quantized per row by the row pass of the same call.
// Replaces _int3_kernel (:467) with int8 x (the int path of _group_accum :226-249),
// called through _call_int3 (:1365) from :1572, and its stacked form _int3_kernel_pfx
// (:1360, from :1794) of iron_weight_only_quant_tpu/ops/pallas/dequant_matmul.py.
// Bound by bytes at decode: per launch, 3/8 byte per weight + f32 scales
// and zeros + int8 x + output, over 3.35 TB/s; at prefill M by 2*M*K*N int8
// operations over 1,979 TOP/s.
// The design is w3a16's (the s21 case of wa_slab_mma.cuh: one warp a slab,
// slab_codes assembling each slab's codes f + 4h from its A and B rows;
// products on the int8 tensor cores by mma.sync m16n8k32; the group sums
// of the codes in the row pass; a cp.async ring; deterministic K-split)
// with one plane: the row pass writes the A8 codes (sx = max|x| / 127, q =
// clip(rint(x / sx), +-127)) per slab and their plain group sums, and the
// product kernel stages and multiplies that one plane, part = pa.  Kp =
// Kb, the B rows; xq is the scratch of slab_planes_bytes (one plane) plus
// the group sums.
#include "wa_slab_mma.cuh"

extern "C" int iwoq_w3a8_matmul(const void* x, int x_bf16, int k_logical, int norm,
                                float eps, const void* qw, const void* s, long long s_rs,
                                long long s_cs, const void* z, long long z_rs,
                                long long z_cs, void* xq, void* sx, void* ws, void* out,
                                int M, int N, int n_out, int Kp, int G, int kc, int splits,
                                void* stream) {
  return iwoq::launch_wa_slab<iwoq::kS21, 1>(x, x_bf16, k_logical, norm, eps, qw, s, s_rs,
                                             s_cs, z, z_rs, z_cs, xq, sx, ws, out, M, N, n_out,
                                             Kp, G, kc, splits, stream);
}
