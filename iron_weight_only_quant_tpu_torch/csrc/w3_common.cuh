// W3 dequant-matmul for Hopper (sm_90a): y[M,N] = x[M,K] @ dequant(qw)[K,N]
// for 3-bit codes in the s21 layout.
//
// Replaces the Pallas TPU kernel in
// iron_weight_only_quant_tpu/ops/pallas/dequant_matmul.py:
//   _int3_kernel (:467) with bf16/f32 x, its stacked form _int3_kernel_pfx
//   (:1360), both launched by _call_int3 (:1365).
// The stacked form needs no kernel of its own: the wrapper offsets the
// weight and side-info base pointers by the layer.  There is no prenorm
// form, as in the JAX package (prenorm_supported, :1481): a pre_norm is
// applied to x in torch before the launch.
//
// Which calls run here: the f32-x calls of w3_matmul, and its bf16-x calls
// outside the rule of the bf16 family of wa_slab_mma.cuh (slab rows or
// group no multiple of 4; dequant_matmul.bf16_mma_route), which takes the
// others on the bf16 tensor cores.
//
// Artifact layout (ops/packing.py, s21): qw is uint8 [3 * Kb, N] with
// Kb = K_stored / 8.  Rows [0, 2 Kb) are array A: byte (a, n) holds four
// 2-bit fields, field j = the low two bits of code (j * 2 Kb + a, n), field
// 3 stored flipped (^ 2).  Rows [2 Kb, 3 Kb) are array B, the MSB plane:
// bit i of byte (r, n) is bit 2 of code (i * Kb + r, n).  So B row r, with
// A rows r and r + Kb, holds the eight codes at K = i * Kb + r (i = 0..7,
// "slab" i): field i / 2 of A row (i % 2) * Kb + r, plus 4 * bit i of B row
// r.  Code q decodes to w = (q - z) * s with the f32 scale and zero-point of
// its group, addressed as side[g * rs + n * cs] (row stride 0 broadcasts
// per-channel / per-tensor side info).  The wrapper guarantees G | Kb, so a
// slab holds whole groups and the group row of (slab i, B row r) is
// i * Kb / G + r / G (per-channel/per-tensor: G = Kb, row stride 0).
//
// What bounds it: at decode (M = 8) each launch streams its packed weight
// once, so it is bound by bytes: 3/8 byte per weight + f32 scales and
// zeros + x + output, over 3.35 TB/s (a quarter fewer code bytes than W4).
// At prefill M the same launch does 2*M*N*K operations and the bound moves
// to operations.
//
// What the design does about the bytes: the TPU kernel's twelve masked
// sub-contractions and its mult/zshift folding fed the MXU raw codes; here
// the codes are decoded exactly in registers instead.  W4's grid (128
// columns x 8 activation rows a block, deterministic grid K-split over B
// rows, second-pass reduce, no atomics).  The eight warps of a block take
// the eight slabs: warp i walks every B row of the block's K range, reads
// one 32-bit word of B and one of A (four columns each; a warp reads 128
// contiguous bytes of a row), decodes slab i's four codes and uses them for
// the kTileM activation rows.  So a warp keeps only its slab's scales and
// zero-points (8 registers) and the block's warps read the same A and B
// lines at the same time: device memory is read once, the repeats hit L1.
// The x columns of all eight slabs for a stage of B rows are staged in
// shared memory as f32.  CUDA-core FMAs, no tensor cores, no TMA pipeline:
// the simple, correct first version.
#pragma once

#include "w4_common.cuh"

namespace iwoq {

constexpr int kSlabs = 8;     // K slabs of the s21 layout, one per warp
constexpr int kStage3 = 128;  // B rows of x staged at a time (all slabs)
static_assert(kSlabs == kKWarps, "one warp per slab");
static_assert(kSlabs * kStage3 * kTileM <= kKWarps * kTileM * kBlockN,
              "the x stage must fit in the reduction buffer");

// The four codes of slab i (bytes 0..3 = four columns) from one A word and
// one B word: field i / 2 of A (field 3 un-flipped) plus 4 * bit i of B.
__device__ __forceinline__ uint32_t s21_codes(uint32_t a, uint32_t b, int i) {
  const uint32_t f = ((a >> (2 * (i >> 1))) & 0x03030303u) ^ ((i >> 1) == 3 ? 0x02020202u : 0u);
  return f | (((b >> i) & 0x01010101u) << 2);
}

// Partial products of one (N-tile, M-tile, K-split) block into ws.
template <typename XT>
__global__ void __launch_bounds__(kThreads)
w3_partial_kernel(const XT* __restrict__ x, int ldx,
                  const uint32_t* __restrict__ qw,  // [3 Kb, N/4] words
                  const float* __restrict__ s, long long s_rs, long long s_cs,
                  const float* __restrict__ z, long long z_rs, long long z_cs,
                  float* __restrict__ ws, int M, int N, int Kb, int G, int kc) {
  __shared__ __align__(16) float smem[kKWarps * kTileM * kBlockN];
  const int lane = threadIdx.x;
  const int slab = threadIdx.y;
  const int tid = slab * kLanes + lane;
  const int n0 = blockIdx.x * kBlockN + lane * kColsPerThread;
  const bool active = n0 < N;
  const int m0 = blockIdx.y * kTileM;
  const int k0 = blockIdx.z * kc;
  const int k1 = min(Kb, k0 + kc);
  const int words_per_row = N / kColsPerThread;
  const int col_word = n0 / kColsPerThread;
  const uint32_t* qa = qw + (size_t)(slab & 1) * Kb * words_per_row;  // A rows of this slab
  const uint32_t* qb = qw + (size_t)2 * Kb * words_per_row;           // B rows
  const int grow0 = slab * (Kb / G);  // first group row of this slab

  float acc[kTileM][kColsPerThread];
#pragma unroll
  for (int m = 0; m < kTileM; ++m)
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) acc[m][j] = 0.f;

  float* xs = smem;  // [kSlabs][kStage3][kTileM]

  for (int c0 = k0; c0 < k1; c0 += kStage3) {
    const int rows = min(kStage3, k1 - c0);
    __syncthreads();
    for (int i = tid; i < kSlabs * kTileM * rows; i += kThreads) {
      const int r = i % rows;  // fastest: coalesced reads of an x row
      const int m = (i / rows) % kTileM;
      const int sl = i / (rows * kTileM);
      float v = 0.f;
      if (m0 + m < M) v = to_f32(x[(size_t)(m0 + m) * ldx + (size_t)sl * Kb + c0 + r]);
      xs[(sl * kStage3 + r) * kTileM + m] = v;
    }
    __syncthreads();

    if (active) {
      int r = c0;
      const int r_end = c0 + rows;
      while (r < r_end) {
        const int g = r / G;
        const int seg_end = min(r_end, (g + 1) * G);
        const long long gr = grow0 + g;
        float sg[kColsPerThread], zg[kColsPerThread];
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) {
          const long long c = (long long)(n0 + j);
          sg[j] = __ldg(s + gr * s_rs + c * s_cs);
          zg[j] = __ldg(z + gr * z_rs + c * z_cs);
        }
#pragma unroll 4
        for (; r < seg_end; ++r) {
          const uint32_t a = __ldg(qa + (size_t)r * words_per_row + col_word);
          const uint32_t b = __ldg(qb + (size_t)r * words_per_row + col_word);
          const uint32_t q4 = s21_codes(a, b, slab);
          const float4* x4 = reinterpret_cast<const float4*>(
              xs + (slab * kStage3 + (r - c0)) * kTileM);
          const float4 x0 = x4[0], x1 = x4[1];
          const float xv[kTileM] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
          for (int j = 0; j < kColsPerThread; ++j) {
            const float w = ((float)((q4 >> (8 * j)) & 0xFFu) - zg[j]) * sg[j];
#pragma unroll
            for (int m = 0; m < kTileM; ++m) acc[m][j] = fmaf(xv[m], w, acc[m][j]);
          }
        }
      }
    }
  }

  store_partials(acc, smem, ws, m0, M, N);
}

template <typename XT>
cudaError_t launch_w3_typed(const void* x, int ldx, const void* qw, const void* s,
                            long long s_rs, long long s_cs, const void* z,
                            long long z_rs, long long z_cs, void* ws, void* out,
                            int M, int N, int n_out, int Kb, int G, int kc,
                            int splits, cudaStream_t stream) {
  const dim3 block(kLanes, kKWarps);
  const dim3 grid((N + kBlockN - 1) / kBlockN, (M + kTileM - 1) / kTileM, splits);
  w3_partial_kernel<XT><<<grid, block, 0, stream>>>(
      static_cast<const XT*>(x), ldx, static_cast<const uint32_t*>(qw),
      static_cast<const float*>(s), s_rs, s_cs, static_cast<const float*>(z),
      z_rs, z_cs, static_cast<float*>(ws), M, N, Kb, G, kc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce<false, XT>(ws, nullptr, out, M, N, n_out, splits, stream);
}

}  // namespace iwoq
