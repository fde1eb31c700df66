// W4 dequant-matmul for Hopper (sm_90a) on the CUDA cores: y[M,N] =
// x[M,K] @ dequant(qw)[K,N], the f32-x calls of w4_matmul and
// w4_matmul_prenorm, and the bf16-x calls whose shape the bf16 family of
// wa_slab_mma.cuh does not take (slab rows or group not a multiple of 4).
// The bf16-x calls of its rule run there, as its affine nib4 layout
// (kNib4B).  This header also holds the deterministic K-split reduce
// (w4_reduce_kernel) that the W3, LUT, A8 and slab kernels share.
//
// Replaces the Pallas TPU kernels in
// iron_weight_only_quant_tpu/ops/pallas/dequant_matmul.py:
//   _int4_kernel (:319) and its stacked form _int4_kernel_pfx (:1712),
//   _int4_kernel_prenorm (:328) and _int4_kernel_prenorm_pfx (:408).
// The stacked forms need no kernel of their own: the wrapper offsets the
// weight and side-info base pointers by the layer.
//
// Artifact layout (ops/packing.py, nib4): qw is uint8 [Kp, N] with
// Kp = K_stored / 2.  Byte (kp, n) holds code (kp, n) in its low nibble and
// code (kp + Kp, n) in its high nibble, stored MSB-flipped (hi ^ 8).
// Scales and zero-points are f32, addressed as side[g * rs + n * cs]: a row
// stride of 0 broadcasts per-channel / per-tensor side info without a copy.
// Packed row kp dequantizes with group row kp / G (low nibble) and
// kp / G + Kp / G (high nibble); the wrapper guarantees G divides Kp.
//
// What bounds it: at decode (M = 8) every launch streams its whole packed
// weight once, so it is bound by bytes: packed weights + f32 scales and
// zeros + x + output, over 3.35 TB/s.  At prefill M the same launch does
// 2*M*N*K operations and the bound moves to operations.
//
// What the design does about the bytes: each weight byte is read from
// device memory exactly once per M-tile, by one 32-bit load per thread per
// packed row (a warp reads 128 contiguous bytes of a row), decoded in
// registers and used for all kTileM activation rows.  Eight warps split
// the block's K range so that enough loads are in flight per SM; a grid
// K-split (blockIdx.z) adds blocks when N alone gives too few.  Partial
// sums go to an f32 workspace [splits, M, N] that a second small kernel
// sums in a fixed order (deterministic, no atomics), scales by the RMSNorm
// factor (prenorm form) and casts to the output type.  The activation tile
// is staged in shared memory as f32 and read back as float4 broadcasts.
// CUDA-core FMAs, no tensor cores: the simple, correct first version, kept
// for f32 x (tolerance 1e-4 against the plain version).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace iwoq {

constexpr int kLanes = 32;                       // threads along N
constexpr int kColsPerThread = 4;                // one 32-bit load = 4 columns
constexpr int kBlockN = kLanes * kColsPerThread; // 128 output columns per block
constexpr int kKWarps = 8;                       // warps splitting the block's K range
constexpr int kTileM = 8;                        // activation rows per block
constexpr int kStage = 256;                      // packed rows of x staged at a time
constexpr int kThreads = kLanes * kKWarps;
static_assert(kKWarps == kTileM, "the prenorm pass gives one warp to each row");
static_assert(2 * kStage * kTileM <= kKWarps * kTileM * kBlockN,
              "the x stage must fit in the reduction buffer");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_out(float* o, float v) { *o = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* o, float v) {
  *o = __float2bfloat16_rn(v);
}

// Row factors of the prenorm form, by the block's warps (one row each):
// r[m] = rsqrt(sum_k x[m,k]^2 / K_logical + eps) over the real columns.
template <typename XT>
__device__ __forceinline__ void prenorm_rows(const XT* __restrict__ x, int ldx,
                                             int m0, int M, int k_logical,
                                             float eps, float* __restrict__ rnorm) {
  const int lane = threadIdx.x;
  const int m = m0 + threadIdx.y;
  if (m >= M) return;
  const XT* xr = x + (size_t)m * ldx;
  float ss = 0.f;
  for (int k = lane; k < k_logical; k += kLanes) {
    const float v = to_f32(xr[k]);
    ss = fmaf(v, v, ss);
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if (lane == 0) rnorm[m] = 1.0f / sqrtf(ss / (float)k_logical + eps);
}

// Sum the kKWarps K-slices of the block in shared memory (smem must hold
// kKWarps * kTileM * kBlockN floats) and write the block's partial tile to
// ws[blockIdx.z, m, n].
__device__ __forceinline__ void store_partials(
    const float (&acc)[kTileM][kColsPerThread], float* smem,
    float* __restrict__ ws, int m0, int M, int N) {
  const int lane = threadIdx.x;
  const int wy = threadIdx.y;
  const int tid = wy * kLanes + lane;
  __syncthreads();
  float* red = smem;  // [kKWarps][kTileM][kBlockN]
#pragma unroll
  for (int m = 0; m < kTileM; ++m)
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j)
      red[(wy * kTileM + m) * kBlockN + lane * kColsPerThread + j] = acc[m][j];
  __syncthreads();
  for (int i = tid; i < kTileM * kBlockN; i += kThreads) {
    const int m = i / kBlockN;
    const int c = i - m * kBlockN;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kKWarps; ++w) v += red[(w * kTileM + m) * kBlockN + c];
    const int gm = m0 + m;
    const int gn = blockIdx.x * kBlockN + c;
    if (gm < M && gn < N) ws[((size_t)blockIdx.z * M + gm) * N + gn] = v;
  }
}

// Partial products of one (N-tile, M-tile, K-split) block into ws.
template <bool PRENORM, typename XT>
__global__ void __launch_bounds__(kThreads)
w4_partial_kernel(const XT* __restrict__ x, int ldx,
                  const uint32_t* __restrict__ qw,  // [Kp, N/4] words
                  const float* __restrict__ s, long long s_rs, long long s_cs,
                  const float* __restrict__ z, long long z_rs, long long z_cs,
                  float* __restrict__ ws, float* __restrict__ rnorm,
                  int M, int N, int Kp, int G, int kc, int k_logical, float eps) {
  __shared__ __align__(16) float smem[kKWarps * kTileM * kBlockN];
  const int lane = threadIdx.x;
  const int wy = threadIdx.y;
  const int tid = wy * kLanes + lane;
  const int n0 = blockIdx.x * kBlockN + lane * kColsPerThread;
  const bool active = n0 < N;
  const int m0 = blockIdx.y * kTileM;
  const int k0 = blockIdx.z * kc;
  const int k1 = min(Kp, k0 + kc);
  const int words_per_row = N / kColsPerThread;
  const int hi_row0 = Kp / G;

  if (PRENORM && blockIdx.x == 0 && blockIdx.z == 0)
    prenorm_rows(x, ldx, m0, M, k_logical, eps, rnorm);

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
    if (active) {
      while (r < r_end) {
        const int g = r / G;
        const int seg_end = min(r_end, (g + 1) * G);
        const int gh = g + hi_row0;
        float sl[kColsPerThread], zl[kColsPerThread];
        float sh[kColsPerThread], zh[kColsPerThread];
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) {
          const long long c = (long long)(n0 + j);
          sl[j] = __ldg(s + g * s_rs + c * s_cs);
          zl[j] = __ldg(z + g * z_rs + c * z_cs);
          sh[j] = __ldg(s + gh * s_rs + c * s_cs);
          zh[j] = __ldg(z + gh * z_rs + c * z_cs);
        }
#pragma unroll 4
        for (; r < seg_end; ++r) {
          const uint32_t w = __ldg(qw + (size_t)r * words_per_row + (n0 / kColsPerThread));
          const float4* xl4 = reinterpret_cast<const float4*>(xs_lo + (r - c0) * kTileM);
          const float4* xh4 = reinterpret_cast<const float4*>(xs_hi + (r - c0) * kTileM);
          const float4 a0 = xl4[0], a1 = xl4[1];
          const float4 b0 = xh4[0], b1 = xh4[1];
          const float xl[kTileM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
          const float xh[kTileM] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int j = 0; j < kColsPerThread; ++j) {
            const uint32_t byte = (w >> (8 * j)) & 0xFFu;
            const float wl = ((float)(byte & 0xFu) - zl[j]) * sl[j];
            const float wh = ((float)((byte >> 4) ^ 8u) - zh[j]) * sh[j];
#pragma unroll
            for (int m = 0; m < kTileM; ++m) {
              acc[m][j] = fmaf(xl[m], wl, acc[m][j]);
              acc[m][j] = fmaf(xh[m], wh, acc[m][j]);
            }
          }
        }
      }
    }
  }

  store_partials(acc, smem, ws, m0, M, N);
}

// out[m, n] = cast(r[m] * sum_s ws[s, m, n]) for n < n_out (drops n_pad).
// PRENORM: r is rnorm[m]; with SQ, rnorm holds each split's partial sums of
// x^2 [splits, M] (the bf16 slab kernel's epilogue norm) and r =
// rsqrt(sum / k_logical + eps) is finished here, the sums in split order.
// Launched as a programmatic dependent of the partial-products kernel (the
// slab kernels, wa_slab_mma.cuh) it first waits for that kernel's end;
// launched plainly, the wait returns at once.
template <bool PRENORM, typename OT, bool SQ = false>
__global__ void w4_reduce_kernel(const float* __restrict__ ws,
                                 const float* __restrict__ rnorm,
                                 OT* __restrict__ out, int M, int N, int n_out,
                                 int splits, int k_logical, float eps) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const long long total = (long long)M * n_out;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const int m = (int)(i / n_out);
    const int n = (int)(i - (long long)m * n_out);
    float v = 0.f;
    for (int sp = 0; sp < splits; ++sp) v += ws[((size_t)sp * M + m) * N + n];
    if (PRENORM && SQ) {
      float ss = 0.f;
      for (int sp = 0; sp < splits; ++sp) ss += rnorm[(size_t)sp * M + m];
      v *= 1.0f / sqrtf(ss / (float)k_logical + eps);
    } else if (PRENORM) {
      v *= rnorm[m];
    }
    store_out(out + i, v);
  }
}

// Second pass of both layouts: the fixed-order K-split sum, row factor and cast.
template <bool PRENORM, typename OT>
cudaError_t launch_reduce(void* ws, void* rnorm, void* out, int M, int N,
                          int n_out, int splits, cudaStream_t stream) {
  const long long total = (long long)M * n_out;
  const int threads = 256;
  const long long want = (total + threads - 1) / threads;
  const int blocks = (int)(want < 4096 ? want : 4096);
  w4_reduce_kernel<PRENORM, OT><<<blocks, threads, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<const float*>(rnorm),
      static_cast<OT*>(out), M, N, n_out, splits, 0, 0.f);
  return cudaGetLastError();
}

template <bool PRENORM, typename XT>
cudaError_t launch_typed(const void* x, int ldx, const void* qw,
                         const void* s, long long s_rs, long long s_cs,
                         const void* z, long long z_rs, long long z_cs,
                         void* ws, void* rnorm, void* out, int M, int N,
                         int n_out, int Kp, int G, int kc, int splits,
                         int k_logical, float eps, cudaStream_t stream) {
  const dim3 block(kLanes, kKWarps);
  const dim3 grid((N + kBlockN - 1) / kBlockN, (M + kTileM - 1) / kTileM, splits);
  w4_partial_kernel<PRENORM, XT><<<grid, block, 0, stream>>>(
      static_cast<const XT*>(x), ldx, static_cast<const uint32_t*>(qw),
      static_cast<const float*>(s), s_rs, s_cs, static_cast<const float*>(z),
      z_rs, z_cs, static_cast<float*>(ws), static_cast<float*>(rnorm), M, N,
      Kp, G, kc, k_logical, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce<PRENORM, XT>(ws, rnorm, out, M, N, n_out, splits, stream);
}

template <bool PRENORM>
int launch(const void* x, int x_bf16, int ldx, const void* qw, const void* s,
           long long s_rs, long long s_cs, const void* z, long long z_rs,
           long long z_cs, void* ws, void* rnorm, void* out, int M, int N,
           int n_out, int Kp, int G, int kc, int splits, int k_logical,
           float eps, void* stream) {
  if (M <= 0 || N <= 0 || N % kColsPerThread || n_out > N || Kp <= 0 ||
      G <= 0 || Kp % G || kc <= 0 || splits <= 0 ||
      (long long)kc * splits < Kp || ldx < 2 * Kp ||
      (PRENORM && (k_logical <= 0 || k_logical > ldx)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = x_bf16
      ? launch_typed<PRENORM, __nv_bfloat16>(x, ldx, qw, s, s_rs, s_cs, z, z_rs, z_cs,
                                             ws, rnorm, out, M, N, n_out, Kp, G,
                                             kc, splits, k_logical, eps, st)
      : launch_typed<PRENORM, float>(x, ldx, qw, s, s_rs, s_cs, z, z_rs, z_cs, ws,
                                     rnorm, out, M, N, n_out, Kp, G, kc, splits,
                                     k_logical, eps, st);
  return (int)err;
}

}  // namespace iwoq

extern "C" const char* iwoq_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
