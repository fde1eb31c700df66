// Native host runtime components (C++), the port's own copy of the JAX
// package's host library.  The card's compute path is the CUDA kernels in
// csrc/; this library accelerates the host-side pipeline:
//
//   * int4/int8 RTN quantization + packing for offline artifact production
//     (70B-class checkpoints would crawl through per-tensor Python loops on
//     a 2-vCPU host) -- exact same semantics as formats/int_codec.py and
//     ops/packing.py, including the split-K nibble layout with the
//     MSB-flipped high nibble and round-half-to-even (an asymmetric zero
//     point of an all-zero group, such as a padded column, is +0.0 as
//     torch.clamp gives it, not the -0.0 that rne(-0.0 / scale) leaves);
//   * a memory-mapped token-shard reader for the data pipeline.
//
// Built with g++ at first use by native/lib.py (under build/host/, keyed by
// a hash of this file and the flags) and loaded via ctypes.

#include <cfenv>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {

int iwoq_version() { return 1; }

// round-half-to-even, matching jnp.round / torch.round
static inline float rne(float x) { return std::nearbyintf(x); }

// Quantize a [K, N] row-major float32 kernel with groups along K
// (quant_axis=0), producing the standard artifact layout:
//   packed  [K/2, N]  uint8  (int4 split-K nibbles, hi ^ 8)
//   scales  [K/G, N]  float32
//   zeros   [K/G, N]  float32 (asymmetric) or zeros[0]=8 replicated (sym)
// Returns 0 on success.
int iwoq_quantize_int4(const float* w, int64_t k, int64_t n, int64_t group,
                       int symmetric, uint8_t* packed, float* scales,
                       float* zeros) {
  if (k % 2 != 0 || group <= 0 || k % group != 0) return -1;
  const int64_t kg = k / group;
  const int64_t kp = k / 2;
  std::fesetround(FE_TONEAREST);

  // temporary per-column codes to avoid re-reading w
  // (column-major walk: strided loads, but packing needs both K-halves)
  for (int64_t col = 0; col < n; ++col) {
    for (int64_t g = 0; g < kg; ++g) {
      const int64_t k0 = g * group;
      float mx = -1e30f, mn = 1e30f;
      for (int64_t i = 0; i < group; ++i) {
        const float v = w[(k0 + i) * n + col];
        mx = mx > v ? mx : v;
        mn = mn < v ? mn : v;
      }
      float scale, zero;
      if (symmetric) {
        float am = std::fabs(mn) > mx ? std::fabs(mn) : mx;
        if (am < 1e-5f) am = 1e-5f;
        scale = am / 7.0f;  // max_int = 2^(4-1)-1
        zero = 8.0f;        // storage offset for signed codes
      } else {
        float range = mx - mn;
        if (range < 1e-5f) range = 1e-5f;
        scale = range / 15.0f;
        zero = rne(-mn / scale) + 0.0f;  // -0.0 -> +0.0
        zero = zero < 0.f ? 0.f : (zero > 15.f ? 15.f : zero);
      }
      scales[g * n + col] = scale;
      zeros[g * n + col] = zero;
    }
    // codes + packing: packed[r] = lo(r) | ((hi(r+kp) ^ 8) << 4)
    for (int64_t r = 0; r < kp; ++r) {
      auto code = [&](int64_t kk) -> uint32_t {
        const int64_t g = kk / group;
        const float scale = scales[g * n + col];
        const float zero = zeros[g * n + col];
        float q;
        if (symmetric) {
          q = rne(w[kk * n + col] / scale);
          q = q < -8.f ? -8.f : (q > 7.f ? 7.f : q);
          q += 8.0f;  // unsigned storage
        } else {
          q = rne(w[kk * n + col] / scale) + zero;
          q = q < 0.f ? 0.f : (q > 15.f ? 15.f : q);
        }
        return (uint32_t)q;
      };
      const uint32_t lo = code(r);
      const uint32_t hi = code(r + kp) ^ 8u;
      packed[r * n + col] = (uint8_t)(lo | (hi << 4));
    }
  }
  return 0;
}

// int8: packed [K, N] two's-complement (code - 128); zeros shifted by -128.
int iwoq_quantize_int8(const float* w, int64_t k, int64_t n, int64_t group,
                       int symmetric, uint8_t* packed, float* scales,
                       float* zeros) {
  if (group <= 0 || k % group != 0) return -1;
  const int64_t kg = k / group;
  std::fesetround(FE_TONEAREST);
  for (int64_t col = 0; col < n; ++col) {
    for (int64_t g = 0; g < kg; ++g) {
      const int64_t k0 = g * group;
      float mx = -1e30f, mn = 1e30f;
      for (int64_t i = 0; i < group; ++i) {
        const float v = w[(k0 + i) * n + col];
        mx = mx > v ? mx : v;
        mn = mn < v ? mn : v;
      }
      float scale, zero;
      if (symmetric) {
        float am = std::fabs(mn) > mx ? std::fabs(mn) : mx;
        if (am < 1e-5f) am = 1e-5f;
        scale = am / 127.0f;
        zero = 0.0f;  // signed codes stored directly
      } else {
        float range = mx - mn;
        if (range < 1e-5f) range = 1e-5f;
        scale = range / 255.0f;
        zero = rne(-mn / scale);
        zero = zero < 0.f ? 0.f : (zero > 255.f ? 255.f : zero);
        zero -= 128.0f;  // storage shift
      }
      scales[g * n + col] = scale;
      zeros[g * n + col] = zero;
      for (int64_t i = 0; i < group; ++i) {
        const int64_t kk = k0 + i;
        float q;
        if (symmetric) {
          q = rne(w[kk * n + col] / scale);
          q = q < -128.f ? -128.f : (q > 127.f ? 127.f : q);
        } else {
          q = rne(w[kk * n + col] / scale) + (zero + 128.0f);
          q = q < 0.f ? 0.f : (q > 255.f ? 255.f : q);
          q -= 128.0f;
        }
        packed[kk * n + col] = (uint8_t)(int8_t)q;
      }
    }
  }
  return 0;
}

int iwoq_pack_int4(const int32_t* codes, int64_t k, int64_t n,
                   uint8_t* packed) {
  if (k % 2 != 0) return -1;
  const int64_t kp = k / 2;
  for (int64_t r = 0; r < kp; ++r)
    for (int64_t col = 0; col < n; ++col) {
      const uint32_t lo = (uint32_t)codes[r * n + col] & 0xF;
      const uint32_t hi = ((uint32_t)codes[(r + kp) * n + col] ^ 8u) & 0xF;
      packed[r * n + col] = (uint8_t)(lo | (hi << 4));
    }
  return 0;
}

int iwoq_unpack_int4(const uint8_t* packed, int64_t k, int64_t n,
                     int32_t* codes) {
  if (k % 2 != 0) return -1;
  const int64_t kp = k / 2;
  for (int64_t r = 0; r < kp; ++r)
    for (int64_t col = 0; col < n; ++col) {
      const uint8_t b = packed[r * n + col];
      codes[r * n + col] = b & 0xF;
      codes[(r + kp) * n + col] = ((b >> 4) ^ 8u) & 0xF;
    }
  return 0;
}

// ------------------------------------------------ mmap token-shard reader

struct TokenShard {
  int32_t* data;
  int64_t count;
  int64_t mapped_bytes;
};

// Opens a raw little-endian int32 token file; returns handle or null.
void* iwoq_shard_open(const char* path) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size % 4 != 0) {
    close(fd);
    return nullptr;
  }
  void* mem = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return nullptr;
  auto* s = new TokenShard{(int32_t*)mem, st.st_size / 4, st.st_size};
  return s;
}

int64_t iwoq_shard_len(void* handle) {
  return handle ? ((TokenShard*)handle)->count : -1;
}

// Copy a [rows, seqlen] batch of windows starting at the given offsets.
int iwoq_shard_batch(void* handle, const int64_t* offsets, int64_t rows,
                     int64_t seqlen, int32_t* out) {
  if (!handle) return -1;
  auto* s = (TokenShard*)handle;
  for (int64_t r = 0; r < rows; ++r) {
    if (offsets[r] < 0 || offsets[r] + seqlen > s->count) return -2;
    std::memcpy(out + r * seqlen, s->data + offsets[r], seqlen * 4);
  }
  return 0;
}

void iwoq_shard_close(void* handle) {
  if (!handle) return;
  auto* s = (TokenShard*)handle;
  munmap(s->data, s->mapped_bytes);
  delete s;
}

}  // extern "C"
