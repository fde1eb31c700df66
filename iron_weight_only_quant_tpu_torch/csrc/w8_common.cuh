// W8 dequant-matmul for Hopper (sm_90a): y[M,N] = x[M,K] @ dequant(qw)[K,N].
//
// Replaces the Pallas TPU kernels in
// iron_weight_only_quant_tpu/ops/pallas/dequant_matmul.py:
//   _int8_kernel (:1057, body _int8_body :1040) and its stacked form
//   _int8_kernel_pfx (:1717), _int8_kernel_prenorm (:380) and
//   _int8_kernel_prenorm_pfx (:413).
// As for W4, the stacked forms are the same kernels: the wrapper offsets
// the weight and side-info base pointers by the layer.
//
// Artifact layout (ops/packing.py, byte): qw is uint8 [K, N] (K = K_stored),
// one byte per code, holding code - 128 in two's complement.  The zero
// points are stored shifted by -128 as well, so (int8_t)byte - z equals the
// logical code minus the logical zero point and
//   w[k, n] = ((int8_t)qw[k, n] - z[k / G, n]) * s[k / G, n].
// Scales and zeros are f32, addressed as side[g * rs + n * cs] with stride
// 0 on broadcast axes (per-channel, per-tensor, symmetric [1, 1] zeros).
//
// What bounds it: at decode (M = 8) each launch streams its whole weight
// once (one byte per weight, twice the W4 bytes), so it is bound by bytes:
// codes + f32 scales and zeros + x + output, over 3.35 TB/s.  At prefill M
// it does 2*M*N*K operations and the bound moves to operations.
//
// Design: the W4 kernel's (w4_common.cuh), with one K stream instead of
// two nibble halves.  A thread loads one 32-bit word (4 columns of one K
// row; a warp reads 128 contiguous bytes), sign-extends each byte, applies
// the group's zero and scale in registers and uses the weight for all
// kTileM activation rows staged in shared memory.  Eight warps split the
// block's K range, a grid K-split adds blocks when N alone gives too few,
// and the same second kernel sums the f32 partials in a fixed order, applies
// the RMSNorm factor (prenorm form, computed by the same row pass as W4) and
// casts.  CUDA-core FMAs only: no tensor cores, no TMA pipeline.
//
// Which calls run here: the f32-x calls of w8_matmul and
// w8_matmul_prenorm.  Their bf16-x calls take the affine byte layout
// (kByteB) of the bf16 family of wa_slab_mma.cuh (bf16 products on the
// tensor cores; the prenorm form with its row factor in the epilogue),
// except the shapes outside its rule (K or group no multiple of 4), which
// stay here (dequant_matmul.bf16_mma_route).
#pragma once

#include "w4_common.cuh"

namespace iwoq {

constexpr int kStage8 = 512;  // K rows of x staged at a time
static_assert(kStage8 * kTileM <= kKWarps * kTileM * kBlockN,
              "the x stage must fit in the reduction buffer");

// Partial products of one (N-tile, M-tile, K-split) block into ws.
template <bool PRENORM, typename XT>
__global__ void __launch_bounds__(kThreads)
w8_partial_kernel(const XT* __restrict__ x, int ldx,
                  const uint32_t* __restrict__ qw,  // [K, N/4] words
                  const float* __restrict__ s, long long s_rs, long long s_cs,
                  const float* __restrict__ z, long long z_rs, long long z_cs,
                  float* __restrict__ ws, float* __restrict__ rnorm,
                  int M, int N, int K, int G, int kc, int k_logical, float eps) {
  __shared__ __align__(16) float smem[kKWarps * kTileM * kBlockN];
  const int lane = threadIdx.x;
  const int wy = threadIdx.y;
  const int tid = wy * kLanes + lane;
  const int n0 = blockIdx.x * kBlockN + lane * kColsPerThread;
  const bool active = n0 < N;
  const int m0 = blockIdx.y * kTileM;
  const int k0 = blockIdx.z * kc;
  const int k1 = min(K, k0 + kc);
  const int words_per_row = N / kColsPerThread;

  if (PRENORM && blockIdx.x == 0 && blockIdx.z == 0)
    prenorm_rows(x, ldx, m0, M, k_logical, eps, rnorm);

  float acc[kTileM][kColsPerThread];
#pragma unroll
  for (int m = 0; m < kTileM; ++m)
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) acc[m][j] = 0.f;

  float* xs = smem;  // [kStage8][kTileM]

  for (int c0 = k0; c0 < k1; c0 += kStage8) {
    const int rows = min(kStage8, k1 - c0);
    __syncthreads();
    for (int i = tid; i < rows * kTileM; i += kThreads) {
      const int m = i / rows;
      const int r = i - m * rows;  // r fastest: coalesced reads of an x row
      xs[r * kTileM + m] =
          m0 + m < M ? to_f32(x[(size_t)(m0 + m) * ldx + c0 + r]) : 0.f;
    }
    __syncthreads();

    const int per = (rows + kKWarps - 1) / kKWarps;
    int r = c0 + wy * per;
    const int r_end = min(c0 + rows, r + per);
    if (active) {
      while (r < r_end) {
        const int g = r / G;
        const int seg_end = min(r_end, (g + 1) * G);
        float sg[kColsPerThread], zg[kColsPerThread];
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) {
          const long long c = (long long)(n0 + j);
          sg[j] = __ldg(s + g * s_rs + c * s_cs);
          zg[j] = __ldg(z + g * z_rs + c * z_cs);
        }
#pragma unroll 4
        for (; r < seg_end; ++r) {
          const uint32_t w = __ldg(qw + (size_t)r * words_per_row + (n0 / kColsPerThread));
          const float4* x4 = reinterpret_cast<const float4*>(xs + (r - c0) * kTileM);
          const float4 a0 = x4[0], a1 = x4[1];
          const float xv[kTileM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
          for (int j = 0; j < kColsPerThread; ++j) {
            // the byte is code - 128 in two's complement: sign-extend it
            const int code = (int)(int8_t)((w >> (8 * j)) & 0xFFu);
            const float wv = ((float)code - zg[j]) * sg[j];
#pragma unroll
            for (int m = 0; m < kTileM; ++m) acc[m][j] = fmaf(xv[m], wv, acc[m][j]);
          }
        }
      }
    }
  }

  store_partials(acc, smem, ws, m0, M, N);
}

template <bool PRENORM, typename XT>
cudaError_t launch_w8_typed(const void* x, int ldx, const void* qw,
                            const void* s, long long s_rs, long long s_cs,
                            const void* z, long long z_rs, long long z_cs,
                            void* ws, void* rnorm, void* out, int M, int N,
                            int n_out, int K, int G, int kc, int splits,
                            int k_logical, float eps, cudaStream_t stream) {
  const dim3 block(kLanes, kKWarps);
  const dim3 grid((N + kBlockN - 1) / kBlockN, (M + kTileM - 1) / kTileM, splits);
  w8_partial_kernel<PRENORM, XT><<<grid, block, 0, stream>>>(
      static_cast<const XT*>(x), ldx, static_cast<const uint32_t*>(qw),
      static_cast<const float*>(s), s_rs, s_cs, static_cast<const float*>(z),
      z_rs, z_cs, static_cast<float*>(ws), static_cast<float*>(rnorm), M, N,
      K, G, kc, k_logical, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce<PRENORM, XT>(ws, rnorm, out, M, N, n_out, splits, stream);
}

template <bool PRENORM>
int launch_w8(const void* x, int x_bf16, int ldx, const void* qw, const void* s,
              long long s_rs, long long s_cs, const void* z, long long z_rs,
              long long z_cs, void* ws, void* rnorm, void* out, int M, int N,
              int n_out, int K, int G, int kc, int splits, int k_logical,
              float eps, void* stream) {
  if (M <= 0 || N <= 0 || N % kColsPerThread || n_out > N || K <= 0 ||
      G <= 0 || K % G || kc <= 0 || splits <= 0 ||
      (long long)kc * splits < K || ldx < K ||
      (PRENORM && (k_logical <= 0 || k_logical > ldx)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = x_bf16
      ? launch_w8_typed<PRENORM, __nv_bfloat16>(x, ldx, qw, s, s_rs, s_cs, z, z_rs,
                                                z_cs, ws, rnorm, out, M, N, n_out,
                                                K, G, kc, splits, k_logical, eps, st)
      : launch_w8_typed<PRENORM, float>(x, ldx, qw, s, s_rs, s_cs, z, z_rs, z_cs,
                                        ws, rnorm, out, M, N, n_out, K, G, kc,
                                        splits, k_logical, eps, st);
  return (int)err;
}

}  // namespace iwoq
