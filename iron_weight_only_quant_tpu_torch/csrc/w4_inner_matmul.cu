// iwoq_w4_inner_matmul: y = x @ dequant(qw) for the W4 nib4 artifact, by
// the factored group form, with one of two decodes of the codes chosen at
// compile time.
//
// Replaces the TPU probe kernel _kernel_variant of
// scripts/probe_w4_inner.py (:67, called through pl.pallas_call at :126),
// modes "f32" and "magic".  It reads the artifact of w4_matmul.cu (layout
// in w4_common.cuh: byte (kp, n) holds code (kp, n) in its low nibble and
// code (kp + Kp, n), MSB-flipped, in its high nibble) and gives the same y.
//
// The factored form never dequantizes a weight.  Per group segment, per
// activation row m and column n, with v the decoded value of each code:
//
//   acc += (x_g . v_g) * s * mult - sum(x_g) * s * (z - zshift)
//
//   f32:   v = (float)code (low half: mult 1, zshift 0); the high nibble's
//          signed view v = (int8)(byte & 0xF0) = 16 * (code - 8)
//          (mult 1/16, zshift 8): one int -> float convert per code.
//   magic: v = bf16(0x4300 | code) = 128 + code exactly (the code fits the
//          7-bit mantissa), mult 1, zshift -128, for both halves: one lop3
//          per pair of codes, (w & 0x000F000F) | 0x43004300 for low
//          nibbles and ((w >> 4) & 0x000F000F) ^ 0x43084308 for high ones
//          (the XOR undoes the MSB flip), then a shift or a mask widens each
//          bf16 lane to f32.  No arithmetic convert.  The +128 cancels in
//          the epilogue; with the bias at 128 (as the TPU kernel has it)
//          the correction costs about 7 bits of the f32 sum, where the f32
//          trick's 2^23 would cost all 24.
//
// The TPU kernel kept the high half of "magic" on the mask-and-convert
// path only because its vector unit had no 8-bit shift; here both halves
// take the bias trick.
//
// What bounds it: as w4_matmul, bytes at decode (M = 8): packed weights +
// f32 scales and zeros + x + output over 3.35 TB/s.  What the design does:
// w4_matmul's tile shape (128 columns, 8 rows, 8 warps splitting K), grid
// K-split and deterministic reduce (store_partials, w4_reduce_kernel).  Per
// code only the decode and one FMA per activation row remain in the loop:
// the scale, zero and activation sums are applied once per group segment
// (a warp's packed rows of one group within the staged x tile), from sums
// taken over the staged x in shared memory after the code loop.  That costs
// two partial-sum registers per (row, column) beside the accumulator.  The
// kernel measures what the decode costs; it is a simple first version:
// CUDA-core FMAs, no tensor cores, no TMA.
#include "w4_common.cuh"

namespace iwoq {

// The four low-half and four high-half values of the four columns of one
// 32-bit word of packed codes (byte j is column j).
template <bool MAGIC>
__device__ __forceinline__ void inner_decode(uint32_t w, float (&lo)[kColsPerThread],
                                             float (&hi)[kColsPerThread]) {
  if (MAGIC) {
    const uint32_t l02 = (w & 0x000F000Fu) | 0x43004300u;
    const uint32_t l13 = ((w >> 8) & 0x000F000Fu) | 0x43004300u;
    const uint32_t h02 = ((w >> 4) & 0x000F000Fu) ^ 0x43084308u;
    const uint32_t h13 = ((w >> 12) & 0x000F000Fu) ^ 0x43084308u;
    lo[0] = __uint_as_float(l02 << 16);
    lo[1] = __uint_as_float(l13 << 16);
    lo[2] = __uint_as_float(l02 & 0xFFFF0000u);
    lo[3] = __uint_as_float(l13 & 0xFFFF0000u);
    hi[0] = __uint_as_float(h02 << 16);
    hi[1] = __uint_as_float(h13 << 16);
    hi[2] = __uint_as_float(h02 & 0xFFFF0000u);
    hi[3] = __uint_as_float(h13 & 0xFFFF0000u);
  } else {
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const uint32_t byte = (w >> (8 * j)) & 0xFFu;
      lo[j] = (float)(byte & 0xFu);
      hi[j] = (float)(int)(int8_t)(byte & 0xF0u);
    }
  }
}

template <bool MAGIC, typename XT>
__global__ void __launch_bounds__(kThreads)
w4_inner_partial_kernel(const XT* __restrict__ x, int ldx,
                        const uint32_t* __restrict__ qw,  // [Kp, N/4] words
                        const float* __restrict__ s, long long s_rs, long long s_cs,
                        const float* __restrict__ z, long long z_rs, long long z_cs,
                        float* __restrict__ ws, int M, int N, int Kp, int G, int kc) {
  constexpr float kMultHi = MAGIC ? 1.f : 1.f / 16.f;
  constexpr float kShiftLo = MAGIC ? -128.f : 0.f;
  constexpr float kShiftHi = MAGIC ? -128.f : 8.f;
  __shared__ __align__(16) float smem[kKWarps * kTileM * kBlockN];
  const int lane = threadIdx.x;
  const int wy = threadIdx.y;
  const int tid = wy * kLanes + lane;
  const int n0 = blockIdx.x * kBlockN + lane * kColsPerThread;
  // lanes past N read column 0 and compute what store_partials never
  // writes: every lane takes part in the warp's shuffles
  const int nc = n0 < N ? n0 : 0;
  const int m0 = blockIdx.y * kTileM;
  const int k0 = blockIdx.z * kc;
  const int k1 = min(Kp, k0 + kc);
  const int words_per_row = N / kColsPerThread;
  const int hi_row0 = Kp / G;

  float acc[kTileM][kColsPerThread];
#pragma unroll
  for (int m = 0; m < kTileM; ++m)
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) acc[m][j] = 0.f;

  float* xs_lo = smem;                    // [kStage][kTileM]
  float* xs_hi = smem + kStage * kTileM;  // [kStage][kTileM]

  for (int c0 = k0; c0 < k1; c0 += kStage) {
    const int rows = min(kStage, k1 - c0);
    __syncthreads();
    for (int i = tid; i < rows * kTileM; i += kThreads) {
      const int m = i / rows;
      const int r = i - m * rows;  // r fastest: coalesced reads of an x row
      float lo = 0.f, hi = 0.f;
      if (m0 + m < M) {
        const XT* xr = x + (size_t)(m0 + m) * ldx;
        lo = to_f32(xr[c0 + r]);
        hi = to_f32(xr[Kp + c0 + r]);
      }
      xs_lo[r * kTileM + m] = lo;
      xs_hi[r * kTileM + m] = hi;
    }
    __syncthreads();

    const int per = (rows + kKWarps - 1) / kKWarps;
    int r = c0 + wy * per;
    const int r_end = min(c0 + rows, r + per);
    while (r < r_end) {  // one group segment a pass; uniform across the warp
      const int seg = r;
      const int g = r / G;
      const int seg_end = min(r_end, (g + 1) * G);
      float pl[kTileM][kColsPerThread], ph[kTileM][kColsPerThread];
#pragma unroll
      for (int m = 0; m < kTileM; ++m)
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) pl[m][j] = ph[m][j] = 0.f;
#pragma unroll 4
      for (; r < seg_end; ++r) {
        const uint32_t w = __ldg(qw + (size_t)r * words_per_row + (nc / kColsPerThread));
        const float4* xl4 = reinterpret_cast<const float4*>(xs_lo + (r - c0) * kTileM);
        const float4* xh4 = reinterpret_cast<const float4*>(xs_hi + (r - c0) * kTileM);
        const float4 a0 = xl4[0], a1 = xl4[1];
        const float4 b0 = xh4[0], b1 = xh4[1];
        const float xl[kTileM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float xh[kTileM] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
        float vl[kColsPerThread], vh[kColsPerThread];
        inner_decode<MAGIC>(w, vl, vh);
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j)
#pragma unroll
          for (int m = 0; m < kTileM; ++m) {
            pl[m][j] = fmaf(xl[m], vl[j], pl[m][j]);
            ph[m][j] = fmaf(xh[m], vh[j], ph[m][j]);
          }
      }

      // The segment's activation sums, from the staged tile: lane
      // (phase, half, m) sums every second row of one (half, row) pair,
      // the two phases meet by one shuffle, and every lane then reads the
      // sixteen sums.
      float xsum = 0.f;
      {
        const float* xs = (lane & kTileM) ? xs_hi : xs_lo;
        for (int rr = seg + (lane >> 4); rr < seg_end; rr += 2)
          xsum += xs[(rr - c0) * kTileM + (lane & (kTileM - 1))];
      }
      xsum += __shfl_xor_sync(0xffffffffu, xsum, 16);
      float sum_lo[kTileM], sum_hi[kTileM];
#pragma unroll
      for (int m = 0; m < kTileM; ++m) {
        sum_lo[m] = __shfl_sync(0xffffffffu, xsum, m);
        sum_hi[m] = __shfl_sync(0xffffffffu, xsum, kTileM + m);
      }

      const int gh = g + hi_row0;
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const long long c = (long long)(nc + j);
        const float sl = __ldg(s + g * s_rs + c * s_cs);
        const float zl = __ldg(z + g * z_rs + c * z_cs);
        const float sh = __ldg(s + gh * s_rs + c * s_cs);
        const float zh = __ldg(z + gh * z_rs + c * z_cs);
        const float bl = sl * (zl - kShiftLo);
        const float ah = sh * kMultHi;
        const float bh = sh * (zh - kShiftHi);
#pragma unroll
        for (int m = 0; m < kTileM; ++m) {
          float a = acc[m][j];
          a = fmaf(pl[m][j], sl, a);
          a = fmaf(-sum_lo[m], bl, a);
          a = fmaf(ph[m][j], ah, a);
          a = fmaf(-sum_hi[m], bh, a);
          acc[m][j] = a;
        }
      }
    }
  }

  store_partials(acc, smem, ws, m0, M, N);
}

template <bool MAGIC, typename XT>
cudaError_t launch_inner(const void* x, int ldx, const void* qw, const void* s,
                         long long s_rs, long long s_cs, const void* z,
                         long long z_rs, long long z_cs, void* ws, void* out,
                         int M, int N, int n_out, int Kp, int G, int kc,
                         int splits, cudaStream_t stream) {
  const dim3 block(kLanes, kKWarps);
  const dim3 grid((N + kBlockN - 1) / kBlockN, (M + kTileM - 1) / kTileM, splits);
  w4_inner_partial_kernel<MAGIC, XT><<<grid, block, 0, stream>>>(
      static_cast<const XT*>(x), ldx, static_cast<const uint32_t*>(qw),
      static_cast<const float*>(s), s_rs, s_cs, static_cast<const float*>(z),
      z_rs, z_cs, static_cast<float*>(ws), M, N, Kp, G, kc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce<false, XT>(ws, nullptr, out, M, N, n_out, splits, stream);
}

template <bool MAGIC>
cudaError_t launch_inner_x(const void* x, int x_bf16, int ldx, const void* qw,
                           const void* s, long long s_rs, long long s_cs,
                           const void* z, long long z_rs, long long z_cs, void* ws,
                           void* out, int M, int N, int n_out, int Kp, int G, int kc,
                           int splits, cudaStream_t st) {
  return x_bf16 ? launch_inner<MAGIC, __nv_bfloat16>(x, ldx, qw, s, s_rs, s_cs, z, z_rs,
                                                     z_cs, ws, out, M, N, n_out, Kp, G,
                                                     kc, splits, st)
                : launch_inner<MAGIC, float>(x, ldx, qw, s, s_rs, s_cs, z, z_rs, z_cs,
                                             ws, out, M, N, n_out, Kp, G, kc, splits, st);
}

}  // namespace iwoq

extern "C" int iwoq_w4_inner_matmul(const void* x, int x_bf16, int ldx, const void* qw,
                                    const void* s, long long s_rs, long long s_cs,
                                    const void* z, long long z_rs, long long z_cs,
                                    void* ws, void* out, int M, int N, int n_out,
                                    int Kp, int G, int kc, int splits, int magic,
                                    void* stream) {
  if (M <= 0 || N <= 0 || N % iwoq::kColsPerThread || n_out > N || Kp <= 0 ||
      G <= 0 || Kp % G || kc <= 0 || splits <= 0 ||
      (long long)kc * splits < Kp || ldx < 2 * Kp || z == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      magic ? iwoq::launch_inner_x<true>(x, x_bf16, ldx, qw, s, s_rs, s_cs, z, z_rs, z_cs,
                                         ws, out, M, N, n_out, Kp, G, kc, splits, st)
            : iwoq::launch_inner_x<false>(x, x_bf16, ldx, qw, s, s_rs, s_cs, z, z_rs, z_cs,
                                          ws, out, M, N, n_out, Kp, G, kc, splits, st);
  return (int)err;
}
