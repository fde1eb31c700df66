// iwoq_gptq_block: the GPTQ / TrueOBS column loop of one block of columns,
// for every row of the weight, in one launch.
//
// Replaces no Pallas kernel: the JAX package compiles this loop with XLA,
// as the lax.fori_loop of iron_weight_only_quant_tpu/quantize/gptq.py
// (:263, body :209-257) and of quantize/trueobs.py (:411, body :382-404).
// Its plain PyTorch version is gptq_block_plain in the port's
// quantize/gptq.py: about a dozen small torch operations a column, each
// dispatched by the host.
//
// What it computes, for columns i1 .. i1 + count - 1 of w [rows, cols] and
// the block's upper factor hinv1 = hinv[i1:i2, i1:i2]: per row, per column
// i in order, the column's grid params (found from the outer w at a group
// boundary when refreshing, else read from the tables), its quantized
// value q and code, the scaled error err = (w - q) / hinv1[i, i] and the
// rank-1 update w[j] -= err * hinv1[i, j] of the columns j > i.  TrueOBS
// adds the loss (w - q)^2 / d^2 / 2, the sparse-outlier select against
// 0.25 * scale^2, and "nearest" (no update).  The outer w is only read: the
// block's errors go out as err1 [rows, count], and the caller's
// torch.matmul carries them to the columns after the block.
//
// Design.  The rows are independent and each row's columns form a serial
// chain, so one warp takes one row: lane l holds columns l, l + 32, l + 64
// and l + 96 of the block in registers (a block of up to 128 columns; a
// wider one keeps its row in err1, in global memory), the pivot column is
// broadcast by __shfl_sync, and a group's min, max and mse sums are warp
// reductions.  The factor's upper triangle, count * (count + 1) / 2 floats
// (33 KB at 128 columns), is loaded once into shared memory and shared by
// the CTA's eight warps; a factor larger than 48 KB is read from global
// memory.  q, codes and err (and TrueOBS's outputs) stay with the lane that
// holds the column and are stored once at the end, row-contiguous.
//
// What bounds it on the H100: not bytes (the block of w in; q, codes and
// err1 out: 16 bytes an element, 8.4 MB at 4096 x 128, 2.5 us at 3.35
// TB/s) nor f32 operations (count^2 a row for the updates), but the
// 128-step serial chain of a row: each column waits for the last one's
// update (a shuffle, two IEEE divisions, the rounding, a shared load and a
// multiply and subtract).  The design hides that latency across rows: one
// warp a row, thousands of rows in flight.  Plain CUDA cores; no tensor
// cores or TMA (the updates are rank-1).
//
// Rounding.  Every operation is rounded as the plain version's torch op
// is.  __fmul_rn / __fsub_rn / __fadd_rn / __fdiv_rn keep nvcc from
// contracting a product and a sum into an FMA (the plain version rounds
// err * hinv1[i, j] before it subtracts) and give IEEE division (torch
// divides by a tensor; _find_params's _div divides by a full tensor);
// rintf is torch.round's ties-to-even.  A solve without mse so equals the
// plain version's on the card bit for bit.  The mse search sums |.|^2.4
// over a group in the warp's order, not torch's, so a row whose two
// shrink steps nearly tie may keep the other one.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace iwoq_gptq {

constexpr int kWarps = 8;           // rows a CTA, one warp each
constexpr int kSlots = 4;           // columns a lane holds in registers
constexpr int kRegCols = 32 * kSlots;
constexpr size_t kSmemMax = 48 * 1024;  // the factor's triangle in shared memory up to this
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const float* w;        // [rows, cols], row stride ldw: the outer w before the block
  long long ldw;
  int rows, cols;
  const float* hinv;     // [cols, cols], strides hs0, hs1: the upper factor
  long long hs0, hs1;
  float* scales;         // [rows, n_groups]: read, or written at a refresh
  float* zeros;
  int n_groups;
  const int* gidx;       // [cols] group of each column, or null: col / gsize
  int gsize, refresh;
  float* q;              // [rows, cols]
  float* codes;          // [rows, cols]
  float* err1;           // [rows, count]
  float* losses;         // [rows, cols] or null (GPTQ)
  unsigned char* outliers;  // [rows, cols] or null (no sparseout)
  const float* thresh;   // [rows] or null
  int i1, count;
  float maxq;
  int sym, trits, mse;
  float norm;
  int grid, steps;
  int nearest;
  int smem;              // the triangle is in shared memory
};

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// the butterfly leaves the same sum on every lane (a + b == b + a)
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// row i of the triangle (its entries j >= i) starts here
__device__ __forceinline__ int tri_off(int i, int count) {
  return i * count - (i * (i - 1)) / 2;
}

// hinv1[i, j] for j >= i
__device__ __forceinline__ float factor(const Args& a, const float* tri, const float* h1,
                                        int i, int j) {
  return a.smem ? tri[tri_off(i, a.count) + j - i] : h1[i * a.hs0 + j * a.hs1];
}

// _find_params on the warp's row segment wrow[0:width]: every lane returns
// the same scale and zero
__device__ void find_params(const Args& a, const float* wrow, int width, int lane,
                            float& scale, float& zero) {
  float mn = INFINITY, mx = -INFINITY;
  for (int j = lane; j < width; j += 32) {
    const float x = wrow[j];
    mn = fminf(mn, x);
    mx = fmaxf(mx, x);
  }
  mn = warp_min(mn);
  mx = warp_max(mx);
  float xmin = fminf(mn, 0.f), xmax = fmaxf(mx, 0.f);
  if (a.sym) {
    xmax = fmaxf(fabsf(xmin), xmax);
    if (xmin < 0.f) xmin = -xmax;
  }
  if (xmin == 0.f && xmax == 0.f) {
    xmin = -1.f;
    xmax = 1.f;
  }
  if (a.trits) {
    scale = xmax;
    zero = xmin;
    return;
  }
  scale = __fdiv_rn(__fsub_rn(xmax, xmin), a.maxq);
  zero = a.sym ? __fmul_rn(__fadd_rn(a.maxq, 1.f), 0.5f) : rintf(__fdiv_rn(-xmin, scale));
  if (!a.mse) return;
  const float zero_sym = zero;
  float best = INFINITY;
  for (int s = 0; s < a.steps; ++s) {
    const float p = __fsub_rn(1.f, __fdiv_rn((float)s, (float)a.grid));
    const float xmin1 = __fmul_rn(p, xmin), xmax1 = __fmul_rn(p, xmax);
    const float scale1 = __fdiv_rn(__fsub_rn(xmax1, xmin1), a.maxq);
    const float zero1 = a.sym ? zero_sym : rintf(__fdiv_rn(-xmin1, scale1));
    float e = 0.f;
    for (int j = lane; j < width; j += 32) {
      const float x = wrow[j];
      const float c = fminf(fmaxf(__fadd_rn(rintf(__fdiv_rn(x, scale1)), zero1), 0.f), a.maxq);
      const float r = __fsub_rn(__fmul_rn(scale1, __fsub_rn(c, zero1)), x);
      e = __fadd_rn(e, powf(fabsf(r), a.norm));
    }
    e = warp_sum(e);
    if (e < best) {
      best = e;
      scale = scale1;
      zero = zero1;
    }
  }
}

// the grid params of column col (g_now: the group they belong to)
__device__ __forceinline__ void params_for(const Args& a, const float* wrow, long long row,
                                           int col, int lane, float& scale, float& zero,
                                           int& g_now) {
  const int g = a.gidx ? a.gidx[col] : col / a.gsize;
  if (a.refresh && col % a.gsize == 0) {
    // the outer w as it was before the block; a last partial group reads
    // the last gsize columns (the JAX package's dynamic_slice)
    find_params(a, wrow + min(col, a.cols - a.gsize), a.gsize, lane, scale, zero);
    if (lane == 0) {
      a.scales[row * a.n_groups + g] = scale;
      a.zeros[row * a.n_groups + g] = zero;
    }
  } else if (g != g_now) {
    scale = a.scales[row * a.n_groups + g];
    zero = a.zeros[row * a.n_groups + g];
  }
  g_now = g;
}

// _quantize_col, then TrueOBS's loss and select; returns err
__device__ __forceinline__ float column(const Args& a, float x, float d, float scale,
                                        float zero, float thr, float& q, float& code,
                                        float& loss, bool& sel) {
  if (a.trits) {  // {zero, 0, scale}, coded 0 / 1 / 2
    const bool hi = x > __fmul_rn(scale, 0.5f);
    const bool lo = x < __fmul_rn(zero, 0.5f);
    q = __fadd_rn(__fmul_rn(hi ? 1.f : 0.f, scale), __fmul_rn(lo ? 1.f : 0.f, zero));
    code = hi ? 2.f : (lo ? 0.f : 1.f);
  } else {
    code = fminf(fmaxf(__fadd_rn(rintf(__fdiv_rn(x, scale)), zero), 0.f), a.maxq);
    q = __fmul_rn(scale, __fsub_rn(code, zero));
  }
  loss = 0.f;
  sel = false;
  if (a.losses) {
    const float e = __fsub_rn(x, q);
    const float e2 = __fmul_rn(e, e);
    loss = __fdiv_rn(e2, __fmul_rn(d, d));
    if (a.thresh && e2 > thr) {
      sel = true;
      loss = 0.f;
      q = x;
    }
    loss = __fmul_rn(loss, 0.5f);
  }
  return __fdiv_rn(__fsub_rn(x, q), d);
}

template <bool kReg>
__global__ void __launch_bounds__(kWarps * 32) gptq_block_kernel(Args a) {
  extern __shared__ float tri[];
  const int count = a.count;
  const float* h1 = a.hinv + a.i1 * a.hs0 + a.i1 * a.hs1;
  if (a.smem) {
    // the unit-stride index runs fastest across the threads
    const bool col_major = a.hs0 == 1;
    for (int t = threadIdx.x; t < count * count; t += blockDim.x) {
      const int i = col_major ? t % count : t / count;
      const int j = col_major ? t / count : t % count;
      if (j >= i) tri[tri_off(i, count) + j - i] = h1[i * a.hs0 + j * a.hs1];
    }
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= a.rows) return;  // a whole warp; no barrier follows
  const float* wrow = a.w + row * a.ldw;
  const long long orow = row * a.cols + a.i1;  // the block's first column in q, codes, ...
  float* erow = a.err1 + row * count;
  const float thr = a.thresh ? a.thresh[row] : 0.f;
  float scale = 0.f, zero = 0.f;
  int g_now = -1;

  if constexpr (kReg) {
    float v[kSlots], qv[kSlots], cv[kSlots], ev[kSlots], lv[kSlots];
    bool ov[kSlots];
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const int j = lane + 32 * k;
      v[k] = j < count ? wrow[a.i1 + j] : 0.f;
      qv[k] = cv[k] = ev[k] = lv[k] = 0.f;
      ov[k] = false;
    }
#pragma unroll
    for (int kk = 0; kk < kSlots; ++kk) {
      for (int ii = 0; ii < 32; ++ii) {
        const int i = 32 * kk + ii;
        if (i >= count) break;
        params_for(a, wrow, row, a.i1 + i, lane, scale, zero, g_now);
        const float x = __shfl_sync(kFull, v[kk], ii);
        float q, code, loss;
        bool sel;
        const float err = column(a, x, factor(a, tri, h1, i, i), scale, zero, thr, q, code,
                                 loss, sel);
        if (lane == ii) {
          qv[kk] = q;
          cv[kk] = code;
          ev[kk] = err;
          lv[kk] = loss;
          ov[kk] = sel;
        }
        if (!a.nearest) {
#pragma unroll
          for (int k = kk; k < kSlots; ++k) {
            const int j = lane + 32 * k;
            if (j > i && j < count) {
              v[k] = __fsub_rn(v[k], __fmul_rn(err, factor(a, tri, h1, i, j)));
            }
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const int j = lane + 32 * k;
      if (j < count) {
        a.q[orow + j] = qv[k];
        a.codes[orow + j] = cv[k];
        erow[j] = ev[k];
        if (a.losses) a.losses[orow + j] = lv[k];
        if (a.outliers) a.outliers[orow + j] = ov[k] ? 1 : 0;
      }
    }
  } else {
    // a block wider than the registers hold: the row's columns live in
    // err1, each replaced by its err once solved
    for (int j = lane; j < count; j += 32) erow[j] = wrow[a.i1 + j];
    __syncwarp();
    for (int i = 0; i < count; ++i) {
      params_for(a, wrow, row, a.i1 + i, lane, scale, zero, g_now);
      const float x = erow[i];
      __syncwarp();  // every lane has read column i before lane 0 replaces it
      float q, code, loss;
      bool sel;
      const float err = column(a, x, factor(a, tri, h1, i, i), scale, zero, thr, q, code,
                               loss, sel);
      if (!a.nearest) {
        for (int j = i + 1 + lane; j < count; j += 32) {
          erow[j] = __fsub_rn(erow[j], __fmul_rn(err, factor(a, tri, h1, i, j)));
        }
      }
      if (lane == 0) {
        a.q[orow + i] = q;
        a.codes[orow + i] = code;
        erow[i] = err;
        if (a.losses) a.losses[orow + i] = loss;
        if (a.outliers) a.outliers[orow + i] = sel ? 1 : 0;
      }
      __syncwarp();
    }
  }
}

}  // namespace iwoq_gptq

extern "C" int iwoq_gptq_block(const void* w, long long ldw, int rows, int cols,
                               const void* hinv, long long hs0, long long hs1, void* scales,
                               void* zeros, int n_groups, const void* gidx, int gsize,
                               int refresh, void* q, void* codes, void* err1, void* losses,
                               void* outliers, const void* thresh, int i1, int count,
                               float maxq, int sym, int trits, int mse, float norm,
                               int grid, int steps, int nearest, void* stream) {
  using namespace iwoq_gptq;
  if (rows <= 0 || cols <= 0 || count <= 0 || i1 < 0 || i1 + count > cols || gsize <= 0 ||
      gsize > cols || n_groups <= 0 || ldw < cols || (mse && (grid <= 0 || steps < 0)) ||
      (outliers != nullptr) != (thresh != nullptr) || (thresh && !losses))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.w = static_cast<const float*>(w);
  a.ldw = ldw;
  a.rows = rows;
  a.cols = cols;
  a.hinv = static_cast<const float*>(hinv);
  a.hs0 = hs0;
  a.hs1 = hs1;
  a.scales = static_cast<float*>(scales);
  a.zeros = static_cast<float*>(zeros);
  a.n_groups = n_groups;
  a.gidx = static_cast<const int*>(gidx);
  a.gsize = gsize;
  a.refresh = refresh;
  a.q = static_cast<float*>(q);
  a.codes = static_cast<float*>(codes);
  a.err1 = static_cast<float*>(err1);
  a.losses = static_cast<float*>(losses);
  a.outliers = static_cast<unsigned char*>(outliers);
  a.thresh = static_cast<const float*>(thresh);
  a.i1 = i1;
  a.count = count;
  a.maxq = maxq;
  a.sym = sym;
  a.trits = trits;
  a.mse = mse;
  a.norm = norm;
  a.grid = grid;
  a.steps = steps;
  a.nearest = nearest;
  const size_t tri_bytes = (size_t)count * (count + 1) / 2 * sizeof(float);
  a.smem = tri_bytes <= kSmemMax;
  const size_t smem = a.smem ? tri_bytes : 0;
  const dim3 blocks((unsigned)((rows + kWarps - 1) / kWarps)), threads(kWarps * 32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (count <= kRegCols) {
    gptq_block_kernel<true><<<blocks, threads, smem, st>>>(a);
  } else {
    gptq_block_kernel<false><<<blocks, threads, smem, st>>>(a);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* iwoq_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
