// Int-activation dequant-matmul for Hopper (sm_90a), A8:
//   y[M,N] = sx[M] * (quantize(x)[M,K] @ dequant(qw)[K,N]),
// one int8 activation plane against the packed int8 (byte) or 3-bit (s21)
// weight codes, one __dp4a per four K values; and the row pass that
// quantizes the activations for A8 and A16.  Every A16 kernel (two int8
// planes) and the nib4 A8 kernel (w4a8, one plane) run on the tensor cores
// in wa_slab_mma.cuh, which builds on this file.
//
// Replaces the A8 paths of the Pallas TPU kernels in
// iron_weight_only_quant_tpu/ops/pallas/dequant_matmul.py: _int8_kernel
// (:1057, body _int8_body :1040) with int8 x, i.e. the int path of
// _group_accum (:226-249), stacked form _int8_kernel_pfx (:1717); and
// _int3_kernel (:467) with int8 x, stacked form _int3_kernel_pfx (:1360),
// through _call_int3 (:1365).  The
// stacked forms are the same kernels: the wrapper offsets the weight and
// side-info base pointers by the layer.  The JAX package quantized the
// activations in XLA (_prep_x :1270-1316); here a row pass of the same
// library does it, launched by the same C entry point.
//
// Three kernels per call, on one stream:
//  1. quantize_rows_kernel, one block per activation row.  Optionally the
//     weightless RMSNorm of the row (x * 1/sqrt(mean(x^2) + eps) over the
//     real columns, cast back to x's type: under activation bits the fused
//     pre-norm is applied before quantizing, as fused_quantized_matmul does
//     at :1518-1522).  Then
//       A8:  sx = max(max|x|, 1e-8) / 127,   q = clip(rint(x / sx), +-127);
//       A16: sx = max(max|x|, 1e-8) / 32512, xi = rint(x / sx),
//            hi = (xi + 128) >> 8, lo = xi - (hi << 8);
//     with IEEE division and rintf (round half to even, as jnp.round), so
//     the codes are bit-equal to the plain version's.  Writes the int8
//     planes [PLANES, M, K_stored] (zero K-pad columns appended after
//     quantizing, so the row max sees only the real columns) and sx [M].
//     The A16 planes are only checked from here (iwoq_quantize_rows); the
//     A16 kernels take the slab row pass of wa_slab_mma.cuh, which writes
//     the same codes.
//  2. wa_partial_kernel (byte): the W4 kernel's grid (w4_common.cuh: 128
//     columns x 8 rows per block, eight warps splitting the block's K
//     range, a grid K-split).  Each thread loads four rows of its four
//     columns with 32-bit loads, transposes the 4x4 bytes with __byte_perm
//     into four words of four K-consecutive codes (one per column), keeps
//     the byte layout's signed code - 128 (zeros are stored shifted by -128
//     alike), and runs one __dp4a per column and activation row against the
//     int8 activations staged in shared memory.
//     The activation sum of the same rows is one more __dp4a against
//     0x01010101.  At each group end
//       part = (float)pa,  acc += part*s - xsum*(s*z),
//     as _group_accum.  Overflow: a group's sum is at most 127 * 128 * G <
//     2^31 for groups G up to 131072 (a per-channel group spans K).
//     wa_slab_partial_kernel (s21): the same grid with W3's warp-per-slab
//     split (w3_common.cuh): warp i walks the block's B rows four at a
//     time, transposes four A words (rows (i % 2) * Kb + r..) and four B
//     words (rows 2 Kb + r..) into per-column words, assembles slab i's four
//     K-consecutive codes (field i / 2, un-flipped, plus 4 * bit i) and runs
//     the same __dp4a sums and per-group epilogue against slab i's
//     activations (K = i * Kb + r..).
//  3. the W4 reduce (w4_reduce_kernel with the row factor): the fixed-order
//     K-split sum, times sx in f32, cast to x's type -- _finish's order.
//
// What bounds it: at decode (M = 8) each launch streams its packed weight
// once, so A8 is bound by bytes (int8 x, codes, f32 sides, output) over
// 3.35 TB/s.  At prefill M the bound is 2*M*K*N int8 operations over 1,979
// dense int8 TOP/s, which only tensor cores reach: this kernel runs the
// products on CUDA cores (__dp4a), the simple and correct first version;
// wa_slab_mma.cuh's mma.sync path takes every A16 layout and nib4 A8, and
// the byte and s21 A8 kernels are later work.
#pragma once

#include "lut_common.cuh"
#include "slab_tile.cuh"
#include "w3_common.cuh"

namespace iwoq {

constexpr int kRowThreads = 256;  // threads of the row pass, one block per row
constexpr int kStageA = 512;      // packed K rows of int8 x staged at a time
constexpr int kStageA3 = 256;     // s21: slab rows of int8 x staged at a time (all slabs)

__device__ __forceinline__ float round_to(float v, float) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Sum (MAX=false) or maximum (MAX=true) of one value per thread of the block.
template <bool MAX>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  const int t = threadIdx.x;
  red[t] = v;
  __syncthreads();
  for (int off = kRowThreads / 2; off > 0; off >>= 1) {
    if (t < off) red[t] = MAX ? fmaxf(red[t], red[t + off]) : red[t] + red[t + off];
    __syncthreads();
  }
  const float out = red[0];
  __syncthreads();
  return out;
}

// Row pass: int8 planes [PLANES, M, k_stored] and sx [M] from x [M, ldx].
template <typename XT, int PLANES, bool NORM>
__global__ void __launch_bounds__(kRowThreads)
quantize_rows_kernel(const XT* __restrict__ x, int ldx, int k_logical, int k_stored,
                     float eps, int8_t* __restrict__ xq, float* __restrict__ sx, int M) {
  __shared__ float red[kRowThreads];
  const int m = blockIdx.x;
  const int t = threadIdx.x;
  const XT* xr = x + (size_t)m * ldx;
  float r = 1.f;
  if (NORM) {
    float ss = 0.f;
    for (int k = t; k < k_logical; k += kRowThreads) {
      const float v = to_f32(xr[k]);
      ss = fmaf(v, v, ss);
    }
    ss = block_reduce<false>(ss, red);
    r = 1.0f / sqrtf(ss / (float)k_logical + eps);
  }
  // the value the quantizer sees: x, or its weightless RMSNorm in x's type
  auto val = [&](int k) {
    const float v = to_f32(xr[k]);
    return NORM ? round_to(v * r, XT()) : v;
  };
  float amax = 0.f;
  for (int k = t; k < k_logical; k += kRowThreads) amax = fmaxf(amax, fabsf(val(k)));
  amax = block_reduce<true>(amax, red);
  const float s = fmaxf(amax, 1e-8f) / (PLANES == 1 ? 127.0f : 32512.0f);
  int8_t* q0 = xq + (size_t)m * k_stored;
  int8_t* q1 = q0 + (size_t)M * k_stored;  // A16: the lo plane
  for (int k = t; k < k_stored; k += kRowThreads) {
    int hi = 0, lo = 0;
    if (k < k_logical) {
      const float q = rintf(val(k) / s);
      if (PLANES == 1) {
        hi = (int)fminf(fmaxf(q, -127.f), 127.f);
      } else {
        const int xi = (int)q;
        hi = (xi + 128) >> 8;
        lo = xi - (hi << 8);
      }
    }
    q0[k] = (int8_t)hi;
    if (PLANES == 2) q1[k] = (int8_t)lo;
  }
  if (t == 0) sx[m] = s;
}

// Four packed rows w[0..3] of four byte columns -> four words, word j
// holding column j's bytes of rows 0..3 (byte i = row i).
__device__ __forceinline__ void transpose4x4(const uint32_t (&w)[4], uint32_t (&c)[4]) {
  const uint32_t a_lo = __byte_perm(w[0], w[1], 0x5140);  // w0.b0 w1.b0 w0.b1 w1.b1
  const uint32_t a_hi = __byte_perm(w[0], w[1], 0x7362);  // w0.b2 w1.b2 w0.b3 w1.b3
  const uint32_t b_lo = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t b_hi = __byte_perm(w[2], w[3], 0x7362);
  c[0] = __byte_perm(a_lo, b_lo, 0x5410);
  c[1] = __byte_perm(a_lo, b_lo, 0x7632);
  c[2] = __byte_perm(a_hi, b_hi, 0x5410);
  c[3] = __byte_perm(a_hi, b_hi, 0x7632);
}

// Partial products of one (N-tile, M-tile, K-split) block into ws, byte
// layout.  xq: the int8 plane [M, ldq], ldq = Kp = K.
__global__ void __launch_bounds__(kThreads)
wa_partial_kernel(const int8_t* __restrict__ xq, int ldq, int M,
                  const uint32_t* __restrict__ qw,  // [Kp, N/4] words
                  const float* __restrict__ s, long long s_rs, long long s_cs,
                  const float* __restrict__ z, long long z_rs, long long z_cs,
                  float* __restrict__ ws, int N, int Kp, int G, int kc) {
  constexpr int kStage4 = kStageA / 4;
  static_assert(kStage4 * kTileM <= kKWarps * kTileM * kBlockN,
                "the x stage must fit in the reduction buffer");
  __shared__ __align__(16) float smem[kKWarps * kTileM * kBlockN];
  int* xs = reinterpret_cast<int*>(smem);  // [kStage4][kTileM] words
  const int lane = threadIdx.x;
  const int wy = threadIdx.y;
  const int tid = wy * kLanes + lane;
  const int n0 = blockIdx.x * kBlockN + lane * kColsPerThread;
  const bool active = n0 < N;
  const int m0 = blockIdx.y * kTileM;
  const int k0 = blockIdx.z * kc;
  const int k1 = min(Kp, k0 + kc);
  const int words_per_row = N / kColsPerThread;

  float acc[kTileM][kColsPerThread];
#pragma unroll
  for (int m = 0; m < kTileM; ++m)
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) acc[m][j] = 0.f;

  for (int c0 = k0; c0 < k1; c0 += kStageA) {
    const int rows4 = min(kStageA, k1 - c0) / 4;  // k0, k1 and c0 are multiples of 4
    __syncthreads();
    for (int i = tid; i < kTileM * rows4; i += kThreads) {
      const int w = i % rows4;  // fastest: coalesced reads of an x row
      const int m = i / rows4;
      int v = 0;
      if (m0 + m < M)
        v = *reinterpret_cast<const int*>(xq + (size_t)(m0 + m) * ldq + c0 + 4 * w);
      xs[w * kTileM + m] = v;
    }
    __syncthreads();

    const int per4 = (rows4 + kKWarps - 1) / kKWarps;
    int r = c0 + 4 * wy * per4;
    const int r_end = min(c0 + 4 * rows4, r + 4 * per4);
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
        int ia[kTileM][kColsPerThread];
        int isum[kTileM];
#pragma unroll
        for (int m = 0; m < kTileM; ++m) {
          isum[m] = 0;
#pragma unroll
          for (int j = 0; j < kColsPerThread; ++j) ia[m][j] = 0;
        }
        for (; r < seg_end; r += 4) {
          uint32_t w[4], col[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            w[i] = __ldg(qw + (size_t)(r + i) * words_per_row + (n0 / kColsPerThread));
          transpose4x4(w, col);
          const int4* x4 = reinterpret_cast<const int4*>(xs + (r - c0) / 4 * kTileM);
          const int4 a0 = x4[0], a1 = x4[1];
          const int xv[kTileM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
          for (int m = 0; m < kTileM; ++m) {
            isum[m] += __dp4a(xv[m], 0x01010101, 0);
#pragma unroll
            for (int j = 0; j < kColsPerThread; ++j)
              ia[m][j] = __dp4a(xv[m], (int)col[j], ia[m][j]);
          }
        }
#pragma unroll
        for (int m = 0; m < kTileM; ++m) {
          const float xsum = (float)isum[m];
#pragma unroll
          for (int j = 0; j < kColsPerThread; ++j)
            acc[m][j] = acc[m][j] + (float)ia[m][j] * sg[j] - xsum * (sg[j] * zg[j]);
        }
      }
    }
  }

  store_partials(acc, smem, ws, m0, M, N);
}

// Partial products of one (N-tile, M-tile, K-split) block into ws for the
// s21 layout with int8 activations (A8): 8 slabs of Kb = K/8 B rows, one
// warp each.  xq: the int8 plane [M, ldq], ldq = 8 * Kb; slab i's
// activations for row r sit at K = i * Kb + r.  qw is [3 Kb, N/4] words:
// the A rows of slab i start at (i % 2) * Kb, the B rows at 2 Kb.
__global__ void __launch_bounds__(kThreads)
wa_slab_partial_kernel(const int8_t* __restrict__ xq, int ldq, int M,
                       const uint32_t* __restrict__ qw,
                       const float* __restrict__ s, long long s_rs, long long s_cs,
                       const float* __restrict__ z, long long z_rs, long long z_cs,
                       float* __restrict__ ws, int N, int Kb, int G, int kc) {
  constexpr int S = kSlabs;
  constexpr int kStage4 = kStageA3 / 4;
  static_assert(S * kStage4 * kTileM <= kKWarps * kTileM * kBlockN,
                "the x stage must fit in the reduction buffer");
  __shared__ __align__(16) float smem[kKWarps * kTileM * kBlockN];
  int* xs = reinterpret_cast<int*>(smem);  // [S][kStage4][kTileM] words
  const int lane = threadIdx.x;
  const int slab = threadIdx.y;
  const int tid = threadIdx.y * kLanes + lane;
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

  for (int c0 = k0; c0 < k1; c0 += kStageA3) {
    const int rows4 = min(kStageA3, k1 - c0) / 4;  // k0, k1 and c0 are multiples of 4
    __syncthreads();
    for (int i = tid; i < S * kTileM * rows4; i += kThreads) {
      const int w = i % rows4;  // fastest: coalesced reads of an x row
      const int m = (i / rows4) % kTileM;
      const int sl = i / (rows4 * kTileM);
      int v = 0;
      if (m0 + m < M)
        v = *reinterpret_cast<const int*>(xq + (size_t)(m0 + m) * ldq + (size_t)sl * Kb + c0 +
                                          4 * w);
      xs[(sl * kStage4 + w) * kTileM + m] = v;
    }
    __syncthreads();

    if (active) {
      int r = c0;
      const int r_end = c0 + 4 * rows4;
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
        int ia[kTileM][kColsPerThread];
        int isum[kTileM];
#pragma unroll
        for (int m = 0; m < kTileM; ++m) {
          isum[m] = 0;
#pragma unroll
          for (int j = 0; j < kColsPerThread; ++j) ia[m][j] = 0;
        }
        for (; r < seg_end; r += 4) {
          uint32_t wa[4], wb[4], ca[4], cb[4];
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            wa[t] = __ldg(qa + (size_t)(r + t) * words_per_row + col_word);
            wb[t] = __ldg(qb + (size_t)(r + t) * words_per_row + col_word);
          }
          transpose4x4(wa, ca);
          transpose4x4(wb, cb);
          int code[kColsPerThread];
#pragma unroll
          for (int j = 0; j < kColsPerThread; ++j) code[j] = (int)s21_codes(ca[j], cb[j], slab);
          const int4* x4 = reinterpret_cast<const int4*>(xs + (slab * kStage4 + (r - c0) / 4) *
                                                                  kTileM);
          const int4 a0 = x4[0], a1 = x4[1];
          const int xv[kTileM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
          for (int m = 0; m < kTileM; ++m) {
            isum[m] = __dp4a(xv[m], 0x01010101, isum[m]);
#pragma unroll
            for (int j = 0; j < kColsPerThread; ++j) ia[m][j] = __dp4a(xv[m], code[j], ia[m][j]);
          }
        }
#pragma unroll
        for (int m = 0; m < kTileM; ++m) {
          const float xsum = (float)isum[m];
#pragma unroll
          for (int j = 0; j < kColsPerThread; ++j)
            acc[m][j] = acc[m][j] + (float)ia[m][j] * sg[j] - xsum * (sg[j] * zg[j]);
        }
      }
    }
  }

  store_partials(acc, smem, ws, m0, M, N);
}

template <typename XT, int PLANES>
cudaError_t launch_quantize_rows(const void* x, int k_logical, int k_stored, int norm,
                                 float eps, void* xq, void* sx, int M,
                                 cudaStream_t stream) {
  const XT* xp = static_cast<const XT*>(x);
  int8_t* q = static_cast<int8_t*>(xq);
  float* sp = static_cast<float*>(sx);
  if (norm)
    quantize_rows_kernel<XT, PLANES, true><<<M, kRowThreads, 0, stream>>>(
        xp, k_logical, k_logical, k_stored, eps, q, sp, M);
  else
    quantize_rows_kernel<XT, PLANES, false><<<M, kRowThreads, 0, stream>>>(
        xp, k_logical, k_logical, k_stored, eps, q, sp, M);
  return cudaGetLastError();
}

template <int PLANES>
cudaError_t quantize_rows(const void* x, int x_bf16, int k_logical, int k_stored,
                          int norm, float eps, void* xq, void* sx, int M,
                          cudaStream_t stream) {
  return x_bf16 ? launch_quantize_rows<__nv_bfloat16, PLANES>(
                      x, k_logical, k_stored, norm, eps, xq, sx, M, stream)
                : launch_quantize_rows<float, PLANES>(
                      x, k_logical, k_stored, norm, eps, xq, sx, M, stream);
}

// The whole A8 call: row pass, partial products, reduce.  x is [M,
// k_logical] contiguous; xq [M, K_stored] int8 and sx [M] f32 are scratch
// from the wrapper, as is ws [splits, M, N].  Kp is the number of packed
// rows the kernel walks: K (byte) or the B rows Kb = K/8 (s21).
template <int LAYOUT>
int launch_wa(const void* x, int x_bf16, int k_logical, int norm, float eps,
              const void* qw, const void* s, long long s_rs, long long s_cs,
              const void* z, long long z_rs, long long z_cs, void* xq, void* sx,
              void* ws, void* out, int M, int N, int n_out, int Kp, int G, int kc,
              int splits, void* stream) {
  static_assert(LAYOUT == kByte || LAYOUT == kS21, "the byte or s21 layout");
  const int k_stored = LAYOUT == kS21 ? 8 * Kp : Kp;
  if (M <= 0 || N <= 0 || N % kColsPerThread || n_out > N || Kp <= 0 || Kp % 4 ||
      G <= 0 || G % 4 || Kp % G || kc <= 0 || kc % 4 || splits <= 0 ||
      (long long)kc * splits < Kp || k_logical <= 0 || k_logical > k_stored)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = quantize_rows<1>(x, x_bf16, k_logical, k_stored, norm, eps, xq, sx, M, st);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(kLanes, kKWarps);
  const dim3 grid((N + kBlockN - 1) / kBlockN, (M + kTileM - 1) / kTileM, splits);
  if constexpr (LAYOUT == kS21)
    wa_slab_partial_kernel<<<grid, block, 0, st>>>(
        static_cast<const int8_t*>(xq), k_stored, M, static_cast<const uint32_t*>(qw),
        static_cast<const float*>(s), s_rs, s_cs, static_cast<const float*>(z), z_rs,
        z_cs, static_cast<float*>(ws), N, Kp, G, kc);
  else
    wa_partial_kernel<<<grid, block, 0, st>>>(
        static_cast<const int8_t*>(xq), k_stored, M, static_cast<const uint32_t*>(qw),
        static_cast<const float*>(s), s_rs, s_cs, static_cast<const float*>(z), z_rs,
        z_cs, static_cast<float*>(ws), N, Kp, G, kc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = x_bf16 ? launch_reduce<true, __nv_bfloat16>(ws, sx, out, M, N, n_out, splits, st)
               : launch_reduce<true, float>(ws, sx, out, M, N, n_out, splits, st);
  return (int)err;
}

}  // namespace iwoq

// The row pass alone (bits 8 or 16), for checking its codes against the
// plain version.
extern "C" int iwoq_quantize_rows(const void* x, int x_bf16, int k_logical,
                                  int k_stored, int bits, int norm, float eps,
                                  void* xq, void* sx, int M, void* stream) {
  if (M <= 0 || k_logical <= 0 || k_logical > k_stored || (bits != 8 && bits != 16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bits == 8 ? iwoq::quantize_rows<1>(x, x_bf16, k_logical, k_stored, norm, eps, xq, sx, M, st)
                : iwoq::quantize_rows<2>(x, x_bf16, k_logical, k_stored, norm, eps, xq, sx, M, st);
  return (int)err;
}
