// LUT (minifloat) dequant-matmul for Hopper (sm_90a):
//   y[M,N] = x[M,K] @ dequant(qw)[K,N],  w = val(code) * s (+ z).
//
// Replaces the Pallas TPU kernels in
// iron_weight_only_quant_tpu/ops/pallas/dequant_matmul.py:
//   _lut4_kernel (:739, called at :1618) and its stacked form
//   _lut4_kernel_pfx (:1732, through :1927): 4-bit minifloat codes in the
//   nib4 layout;
//   _lut8_kernel (:811, called at :1628) and its stacked form
//   _lut8_kernel_pfx (:1737, through :1927): byte minifloat codes (fp8, and
//   the byte-per-code fp6).
// The stacked forms are the same kernels: the wrapper offsets the weight and
// side-info base pointers by the layer.
//
// Artifact layout (ops/packing.py): nib4 is uint8 [Kp, N], Kp = K_stored/2,
// byte (kp, n) holding code (kp, n) in its low nibble and code (kp + Kp, n)
// in its high nibble, stored MSB-flipped (hi ^ 8), as W4; byte is uint8
// [K, N] holding code - 128, as W8.  Codes are plain unsigned minifloat
// codewords: sign bit, exp_bits exponent field, mant_bits mantissa field.
// Scales are f32, addressed as s[g * rs + n * cs] with stride 0 on broadcast
// axes; zeros likewise, or a null pointer: symmetric minifloat artifacts
// carry no zero (has_z = false in the TPU kernels).
//
// Decode: a table in shared memory, filled per block by the bit assembly of
// _minifloat_decode (:643) from exp_bits and mant_bits (never from the
// artifact's codebook, so an approximate codebook cannot reach a kernel):
// normals assemble their f32 bits, subnormals are mant * 2^(1-bias-M), the
// sign negates (a sign-only code decodes to -0, as code_to_float).  16
// entries for nib4 (one bank each, so a warp's lookups never conflict), 256
// for byte, indexed by the stored byte.
//
// Accumulation (_lut_accum :724): per element w = val * s, one fmaf per
// activation row as W4/W8 do; the zero of an asymmetric artifact is not
// added per element but per group in the epilogue of each group segment,
// acc += sum(x) * z, with the activation sum of the segment's rows.
//
// What bounds it: as W4 (nib4) and W8 (byte): at decode (M = 8) each launch
// streams its packed weight once, bound by bytes (codes + f32 scales [+
// zeros] + x + output) over 3.35 TB/s; at prefill M by 2*M*N*K operations.
// The design is W4's and W8's (w4_common.cuh, w8_common.cuh): one 32-bit
// load per thread per packed row, decoded in registers and used for all
// kTileM activation rows staged in shared memory, eight warps splitting the
// block's K range, a grid K-split, and the same deterministic second pass
// over the f32 partials.  CUDA-core FMAs: the simple and correct first
// version, no tensor cores, no TMA pipeline.
#pragma once

#include "w8_common.cuh"

namespace iwoq {

// Exact value of minifloat codeword `code` (E exp_bits, M mant_bits, bias
// 2^(E-1) - 1, no inf/nan), by f32 bit assembly.
__device__ __forceinline__ float minifloat_value(int code, int exp_bits, int mant_bits) {
  const int bias = (1 << (exp_bits - 1)) - 1;
  const int sign = (code >> (exp_bits + mant_bits)) & 1;
  const int expf = (code >> mant_bits) & ((1 << exp_bits) - 1);
  const int mant = code & ((1 << mant_bits) - 1);
  const float v = expf == 0
      ? ldexpf((float)mant, 1 - bias - mant_bits)
      : __int_as_float(((expf - bias + 127) << 23) | (mant << (23 - mant_bits)));
  return sign ? -v : v;
}

// The exact int8 grid of the A16 path (_minifloat_decode_int :683):
// value * 2^t = +-(mant_full << (max(exp_field, 1) - 1)), t = M + bias - 1.
__device__ __forceinline__ int minifloat_int(int code, int exp_bits, int mant_bits) {
  const int sign = (code >> (exp_bits + mant_bits)) & 1;
  const int expf = (code >> mant_bits) & ((1 << exp_bits) - 1);
  const int mant_full = ((expf != 0) << mant_bits) | (code & ((1 << mant_bits) - 1));
  const int ival = mant_full << (max(expf, 1) - 1);
  return sign ? -ival : ival;
}

// Partial products of one (N-tile, M-tile, K-split) block into ws.
// NIB4: qw is [Kp, N/4] words, packed row r meets K columns r (low nibbles)
// and Kp + r (high nibbles); else qw is [K, N/4] words of code - 128.
template <bool NIB4, typename XT>
__global__ void __launch_bounds__(kThreads)
lut_partial_kernel(const XT* __restrict__ x, int ldx,
                   const uint32_t* __restrict__ qw,
                   const float* __restrict__ s, long long s_rs, long long s_cs,
                   const float* __restrict__ z, long long z_rs, long long z_cs,
                   float* __restrict__ ws, int M, int N, int Kp, int G, int kc,
                   int exp_bits, int mant_bits) {
  constexpr int H = NIB4 ? 2 : 1;            // K streams per packed row
  constexpr int kTab = NIB4 ? 16 : 256;      // table entries
  constexpr int kStageL = NIB4 ? kStage : kStage8;
  static_assert(H * kStageL * kTileM <= kKWarps * kTileM * kBlockN,
                "the x stage must fit in the reduction buffer");
  __shared__ __align__(16) float smem[kKWarps * kTileM * kBlockN];
  __shared__ float tab[kTab];
  const int lane = threadIdx.x;
  const int wy = threadIdx.y;
  const int tid = wy * kLanes + lane;
  const int n0 = blockIdx.x * kBlockN + lane * kColsPerThread;
  const bool active = n0 < N;
  const bool has_z = z != nullptr;
  const int m0 = blockIdx.y * kTileM;
  const int k0 = blockIdx.z * kc;
  const int k1 = min(Kp, k0 + kc);
  const int words_per_row = N / kColsPerThread;
  const int hi_row0 = Kp / G;

  // the byte layout stores code - 128: entry b holds the value of code b ^ 0x80
  for (int i = tid; i < kTab; i += kThreads)
    tab[i] = minifloat_value(NIB4 ? i : (i ^ 0x80), exp_bits, mant_bits);
  // (the stage loop's first __syncthreads orders the table before its use)

  float acc[kTileM][kColsPerThread];
#pragma unroll
  for (int m = 0; m < kTileM; ++m)
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) acc[m][j] = 0.f;

  for (int c0 = k0; c0 < k1; c0 += kStageL) {
    const int rows = min(kStageL, k1 - c0);
    __syncthreads();
    for (int i = tid; i < rows * kTileM; i += kThreads) {
      const int m = i / rows;
      const int r = i - m * rows;  // r fastest: coalesced reads of an x row
#pragma unroll
      for (int h = 0; h < H; ++h) {
        float v = 0.f;
        if (m0 + m < M) v = to_f32(x[(size_t)(m0 + m) * ldx + h * Kp + c0 + r]);
        smem[(h * kStageL + r) * kTileM + m] = v;
      }
    }
    __syncthreads();

    const int per = (rows + kKWarps - 1) / kKWarps;
    int r = c0 + wy * per;
    const int r_end = min(c0 + rows, r + per);
    if (active) {
      while (r < r_end) {
        const int g = r / G;
        const int seg_end = min(r_end, (g + 1) * G);
        float sg[H][kColsPerThread], zg[H][kColsPerThread], xsum[H][kTileM];
#pragma unroll
        for (int h = 0; h < H; ++h) {
#pragma unroll
          for (int j = 0; j < kColsPerThread; ++j) {
            const long long c = (long long)(n0 + j);
            const long long gr = g + h * hi_row0;
            sg[h][j] = __ldg(s + gr * s_rs + c * s_cs);
            zg[h][j] = has_z ? __ldg(z + gr * z_rs + c * z_cs) : 0.f;
          }
#pragma unroll
          for (int m = 0; m < kTileM; ++m) xsum[h][m] = 0.f;
        }
#pragma unroll 4
        for (; r < seg_end; ++r) {
          const uint32_t w = __ldg(qw + (size_t)r * words_per_row + (n0 / kColsPerThread));
#pragma unroll
          for (int h = 0; h < H; ++h) {
            const float4* x4 = reinterpret_cast<const float4*>(
                smem + (h * kStageL + (r - c0)) * kTileM);
            const float4 a0 = x4[0], a1 = x4[1];
            const float xv[kTileM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
            for (int m = 0; m < kTileM; ++m) xsum[h][m] += xv[m];
#pragma unroll
            for (int j = 0; j < kColsPerThread; ++j) {
              const uint32_t byte = (w >> (8 * j)) & 0xFFu;
              const uint32_t idx = !NIB4 ? byte : h == 0 ? (byte & 0xFu) : ((byte >> 4) ^ 8u);
              const float wv = tab[idx] * sg[h][j];
#pragma unroll
              for (int m = 0; m < kTileM; ++m) acc[m][j] = fmaf(xv[m], wv, acc[m][j]);
            }
          }
        }
        if (has_z) {
#pragma unroll
          for (int h = 0; h < H; ++h)
#pragma unroll
            for (int m = 0; m < kTileM; ++m)
#pragma unroll
              for (int j = 0; j < kColsPerThread; ++j)
                acc[m][j] = fmaf(xsum[h][m], zg[h][j], acc[m][j]);
        }
      }
    }
  }

  store_partials(acc, smem, ws, m0, M, N);
}

template <bool NIB4, typename XT>
cudaError_t launch_lut_typed(const void* x, int ldx, const void* qw,
                             const void* s, long long s_rs, long long s_cs,
                             const void* z, long long z_rs, long long z_cs,
                             void* ws, void* out, int M, int N, int n_out, int Kp,
                             int G, int kc, int splits, int exp_bits, int mant_bits,
                             cudaStream_t stream) {
  const dim3 block(kLanes, kKWarps);
  const dim3 grid((N + kBlockN - 1) / kBlockN, (M + kTileM - 1) / kTileM, splits);
  lut_partial_kernel<NIB4, XT><<<grid, block, 0, stream>>>(
      static_cast<const XT*>(x), ldx, static_cast<const uint32_t*>(qw),
      static_cast<const float*>(s), s_rs, s_cs, static_cast<const float*>(z),
      z_rs, z_cs, static_cast<float*>(ws), M, N, Kp, G, kc, exp_bits, mant_bits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce<false, XT>(ws, nullptr, out, M, N, n_out, splits, stream);
}

// The whole call: partial products, then the W4 reduce (fixed-order K-split
// sum, cast).  Kp is the number of packed rows: K/2 (nib4) or K (byte).
// z may be null (no zero points).
template <bool NIB4>
int launch_lut(const void* x, int x_bf16, int ldx, const void* qw, const void* s,
               long long s_rs, long long s_cs, const void* z, long long z_rs,
               long long z_cs, void* ws, void* out, int M, int N, int n_out, int Kp,
               int G, int kc, int splits, int exp_bits, int mant_bits, void* stream) {
  if (M <= 0 || N <= 0 || N % kColsPerThread || n_out > N || Kp <= 0 ||
      G <= 0 || Kp % G || kc <= 0 || splits <= 0 ||
      (long long)kc * splits < Kp || ldx < (NIB4 ? 2 : 1) * Kp ||
      exp_bits < 1 || mant_bits < 0 || 1 + exp_bits + mant_bits > (NIB4 ? 4 : 8))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = x_bf16
      ? launch_lut_typed<NIB4, __nv_bfloat16>(x, ldx, qw, s, s_rs, s_cs, z, z_rs, z_cs,
                                              ws, out, M, N, n_out, Kp, G, kc, splits,
                                              exp_bits, mant_bits, st)
      : launch_lut_typed<NIB4, float>(x, ldx, qw, s, s_rs, s_cs, z, z_rs, z_cs, ws,
                                      out, M, N, n_out, Kp, G, kc, splits, exp_bits,
                                      mant_bits, st);
  return (int)err;
}

}  // namespace iwoq
