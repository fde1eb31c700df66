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
//   the byte-per-code fp6);
//   _lut6_kernel (:835) and its stacked form _lut6_kernel_pfx (:887), both
//   through _call_lut6 (:939, called at :1575 and :1798): 6-bit minifloat
//   codes (fp6) in the nq42 layout.
// The stacked forms are the same kernels: the wrapper offsets the weight and
// side-info base pointers by the layer.
//
// Artifact layout (ops/packing.py): nib4 is uint8 [Kp, N], Kp = K_stored/2,
// byte (kp, n) holding code (kp, n) in its low nibble and code (kp + Kp, n)
// in its high nibble, stored MSB-flipped (hi ^ 8), as W4; byte is uint8
// [K, N] holding code - 128, as W8; nq42 is uint8 [3 Kq, N], Kq = K_stored/4,
// one nibble array laid out as nib4 over the four K quarters (rows [0, Kq):
// quarter 0 low, quarter 2 high; rows [Kq, 2 Kq): quarters 1 and 3) and one
// quad array (row 2 Kq + r, bits 2j..2j+1: the top two bits of quarter j's
// code at K = j Kq + r), so quad row r serves K columns r, r + Kq, r + 2 Kq
// and r + 3 Kq from three bytes.  Codes are plain unsigned minifloat
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
// entries for nib4 (one bank each, so a warp's lookups never conflict), 64
// for nq42 (two codes a bank: a warp's lookups may conflict two ways), 256
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
// load per thread per packed row (nq42: three, the two nibble rows and the
// quad row of its four columns, 16 codes), decoded in registers and used
// for all kTileM activation rows staged in shared memory (H = 1, 2 or 4 K
// streams a packed row: byte, nib4, nq42), eight warps splitting the
// block's K range, a grid K-split, and the same deterministic second pass
// over the f32 partials.  A group never straddles the streams (the wrapper
// checks G | Kp), so stream h of row r uses group row r / G + h * Kp / G.
// CUDA-core FMAs: the simple and correct first version, no tensor cores,
// no TMA pipeline.
//
// Which calls run here: the f32-x calls of lut4_matmul, lut6_matmul and
// lut8_matmul.  Their bf16-x calls take the bf16 family of wa_slab_mma.cuh
// (bf16 products on the tensor cores), except the shapes outside its rule
// (slab rows or group no multiple of 4: the byte-per-code fp6, whose K is
// no multiple of 4, among them), which stay here
// (dequant_matmul.bf16_mma_route).
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

// The table index of stream h's code in byte j of a packed row's words:
// byte (H = 1, w0 = code - 128); nib4 (H = 2, w0: low nibble, high nibble
// flipped); nq42 (H = 4, w0 and w1 the nibble rows of quarters 0/2 and 1/3,
// w2 the quad row).
template <int H>
__device__ __forceinline__ uint32_t lut_index(uint32_t w0, uint32_t w1, uint32_t w2,
                                              int j, int h) {
  const uint32_t byte = ((H == 4 && (h & 1) ? w1 : w0) >> (8 * j)) & 0xFFu;
  if (H == 1) return byte;
  const uint32_t nib = h < H / 2 ? (byte & 0xFu) : ((byte >> 4) ^ 8u);
  if (H == 2) return nib;
  return nib | (((w2 >> (8 * j + 2 * h)) & 3u) << 4);
}

// Partial products of one (N-tile, M-tile, K-split) block into ws.  H K
// streams a packed row: packed row r meets K columns h * Kp + r.  H = 1:
// qw is [K, N/4] words of code - 128; H = 2 (nib4): [Kp, N/4] words, low
// nibbles stream 0, high nibbles stream 1; H = 4 (nq42): [3 Kp, N/4] words,
// Kp = K/4 quad rows (lut_index).
template <int H, typename XT>
__global__ void __launch_bounds__(kThreads)
lut_partial_kernel(const XT* __restrict__ x, int ldx,
                   const uint32_t* __restrict__ qw,
                   const float* __restrict__ s, long long s_rs, long long s_cs,
                   const float* __restrict__ z, long long z_rs, long long z_cs,
                   float* __restrict__ ws, int M, int N, int Kp, int G, int kc,
                   int exp_bits, int mant_bits) {
  static_assert(H == 1 || H == 2 || H == 4, "byte, nib4 or nq42");
  constexpr int kTab = H == 1 ? 256 : H == 2 ? 16 : 64;  // table entries
  constexpr int kStageL = H == 1 ? kStage8 : kStage;
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
    tab[i] = minifloat_value(H == 1 ? (i ^ 0x80) : i, exp_bits, mant_bits);
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
          const uint32_t* wr = qw + (size_t)r * words_per_row + (n0 / kColsPerThread);
          const uint32_t w0 = __ldg(wr);
          const uint32_t w1 = H == 4 ? __ldg(wr + (size_t)Kp * words_per_row) : 0u;
          const uint32_t w2 = H == 4 ? __ldg(wr + (size_t)2 * Kp * words_per_row) : 0u;
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
              const float wv = tab[lut_index<H>(w0, w1, w2, j, h)] * sg[h][j];
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

template <int H, typename XT>
cudaError_t launch_lut_typed(const void* x, int ldx, const void* qw,
                             const void* s, long long s_rs, long long s_cs,
                             const void* z, long long z_rs, long long z_cs,
                             void* ws, void* out, int M, int N, int n_out, int Kp,
                             int G, int kc, int splits, int exp_bits, int mant_bits,
                             cudaStream_t stream) {
  const dim3 block(kLanes, kKWarps);
  const dim3 grid((N + kBlockN - 1) / kBlockN, (M + kTileM - 1) / kTileM, splits);
  lut_partial_kernel<H, XT><<<grid, block, 0, stream>>>(
      static_cast<const XT*>(x), ldx, static_cast<const uint32_t*>(qw),
      static_cast<const float*>(s), s_rs, s_cs, static_cast<const float*>(z),
      z_rs, z_cs, static_cast<float*>(ws), M, N, Kp, G, kc, exp_bits, mant_bits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce<false, XT>(ws, nullptr, out, M, N, n_out, splits, stream);
}

// The whole call: partial products, then the W4 reduce (fixed-order K-split
// sum, cast).  Kp is the number of packed rows a stream has: K (byte, H =
// 1), K/2 (nib4, H = 2) or the K/4 quad rows (nq42, H = 4).  z may be null
// (no zero points).
template <int H>
int launch_lut(const void* x, int x_bf16, int ldx, const void* qw, const void* s,
               long long s_rs, long long s_cs, const void* z, long long z_rs,
               long long z_cs, void* ws, void* out, int M, int N, int n_out, int Kp,
               int G, int kc, int splits, int exp_bits, int mant_bits, void* stream) {
  if (M <= 0 || N <= 0 || N % kColsPerThread || n_out > N || Kp <= 0 ||
      G <= 0 || Kp % G || kc <= 0 || splits <= 0 ||
      (long long)kc * splits < Kp || ldx < H * Kp ||
      exp_bits < 1 || mant_bits < 0 ||
      1 + exp_bits + mant_bits > (H == 1 ? 8 : H == 2 ? 4 : 6))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = x_bf16
      ? launch_lut_typed<H, __nv_bfloat16>(x, ldx, qw, s, s_rs, s_cs, z, z_rs, z_cs,
                                              ws, out, M, N, n_out, Kp, G, kc, splits,
                                              exp_bits, mant_bits, st)
      : launch_lut_typed<H, float>(x, ldx, qw, s, s_rs, s_cs, z, z_rs, z_cs, ws,
                                      out, M, N, n_out, Kp, G, kc, splits, exp_bits,
                                      mant_bits, st);
  return (int)err;
}

}  // namespace iwoq
