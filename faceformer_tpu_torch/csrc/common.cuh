// Shared device helpers for the port's kernels: dtype conversion, rounding
// to the compute type, warp reductions, the first-index argmax merge and
// the counter-based keep mask of attention dropout.
#pragma once

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define FF_EXPORT extern "C" __attribute__((visibility("default")))

// Compute types the wrappers pass as an int.
enum FFDtype { FF_FLOAT32 = 0, FF_BFLOAT16 = 1 };

namespace ff {

// Mask fill: the float32 minimum, never -inf (models/layers.py:116-119).
constexpr float NEG = -FLT_MAX;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T's precision, back in fp32 (the JAX code's .astype(T)).
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Argmax merge with jnp.argmax's rule: the larger value wins, and on a tie
// the LOWER index wins. A shuffle tree does not give this by itself.
__device__ __forceinline__ void argmax_merge(float& v, int& i, float v2, int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

// ---------------------------------------------------------------------------
// Attention-probability dropout: a counter-based keep mask (Philox4x32-10,
// written out here; no cuRAND). It takes the place of the TPU PRNG that
// faceformer_tpu/ops/flash.py::_keep_mask reseeds per (grid block, head).
// The key is the call's 64-bit seed; the counter is (key index / 4, query
// index, head, sequence) and holds nothing of a kernel's tiling, so the
// forward and the backward kernels regenerate the same mask whatever their
// blocks, and ops/flash.py::philox_keep_mask computes the very same bits in
// integer tensor ops. One Philox call yields the bits of four neighbouring
// keys. keep <=> bits < threshold, threshold = uint32((1 - rate) * 2^32).
// A kept probability is multiplied by the fp32 value of 1 / (1 - rate), as
// the plain versions do: a division by a run-time value costs these kernels
// more than the Philox draw does.
// ---------------------------------------------------------------------------
struct Dropout {
  uint32_t seed_lo = 0, seed_hi = 0;
  uint32_t threshold = 0;  // 0: dropout off
  float scale = 1.f;       // 1 / (1 - rate) in fp32; kept probabilities are multiplied by it
  __host__ __device__ bool on() const { return threshold != 0u; }
};

inline Dropout make_dropout(unsigned long long seed, uint32_t threshold, float scale) {
  Dropout d;
  d.seed_lo = static_cast<uint32_t>(seed & 0xffffffffull);
  d.seed_hi = static_cast<uint32_t>(seed >> 32);
  d.threshold = threshold;
  d.scale = scale;
  return d;
}

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
  constexpr uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  constexpr uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(M0, c.x), lo0 = M0 * c.x;
    const uint32_t hi1 = __umulhi(M1, c.z), lo1 = M1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += W0;
    k1 += W1;
  }
  return c;
}

// The random bits of keys 4*(j/4) .. 4*(j/4)+3 for query i of (sequence n,
// head h).
__device__ __forceinline__ uint4 dropout_bits4(const Dropout& dr, int n, int h, int i, int j) {
  return philox4x32_10(make_uint4((uint32_t)(j >> 2), (uint32_t)i, (uint32_t)h, (uint32_t)n),
                       dr.seed_lo, dr.seed_hi);
}

__device__ __forceinline__ bool dropout_keep(const Dropout& dr, int n, int h, int i, int j) {
  const uint4 r = dropout_bits4(dr, n, h, i, j);
  const int c = j & 3;
  const uint32_t bits = c == 0 ? r.x : c == 1 ? r.y : c == 2 ? r.z : r.w;
  return bits < dr.threshold;
}

// The mma C fragment of a (16 rows x 8 keys) tile holds, in lane (g, tig),
// keys j = tile + 2 tig and j + 1 of rows ra = g and rb = g + 8: lanes tig
// and tig ^ 1 hold the two halves of one 4-key group. The even lane draws
// the group's bits for row ra, the odd lane for row rb, and they swap
// halves, so a tile costs each lane one Philox call, not two. Every lane of
// the warp must call it. keep[0..1]: row ra, keys j, j + 1; keep[2..3]: rb.
__device__ __forceinline__ void dropout_keep_rows(const Dropout& dr, int n, int h, int ra, int rb,
                                                  int j, int tig, bool* keep) {
  const bool odd = (tig & 1) != 0;
  const uint4 r = dropout_bits4(dr, n, h, odd ? rb : ra, j);
  const uint32_t g0 = __shfl_xor_sync(0xffffffffu, odd ? r.x : r.z, 1);
  const uint32_t g1 = __shfl_xor_sync(0xffffffffu, odd ? r.y : r.w, 1);
  keep[0] = (odd ? g0 : r.x) < dr.threshold;
  keep[1] = (odd ? g1 : r.y) < dr.threshold;
  keep[2] = (odd ? r.z : g0) < dr.threshold;
  keep[3] = (odd ? r.w : g1) < dr.threshold;
}

// ---------------------------------------------------------------------------
// Tensor-core helpers: mma.sync m16n8k16 (bf16 inputs, fp32 accumulation).
// Fragment layout (g = lane / 4, tig = lane % 4): A (16x16, row-major) a0 =
// (row g, cols 2tig..+1), a1 = (row g+8, same), a2 = (row g, cols 2tig+8..),
// a3 = (row g+8, cols 2tig+8..); B (16x8) b0 = (k 2tig..+1, col g), b1 =
// (k 2tig+8.., col g); C (16x8) c0,c1 = (row g, cols 2tig..+1), c2,c3 =
// (row g+8, same). The lower 16 bits of a register hold the lower index.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// ---------------------------------------------------------------------------
// Asynchronous copies into shared memory (cp.async) and ldmatrix.
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
// 4 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int PENDING> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

// Four 8x8 bf16 matrices from shared memory; lanes 8m..8m+7 give the row
// addresses of matrix m, and r[m] is the lane's fragment of matrix m: row
// lane / 4, columns 2 (lane % 4) and + 1 (with .trans: of the transpose).
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// x = hi + mid + lo with each term a bf16 value; the remainder is below
// 2^-24 |x|, so three bf16 products reproduce an fp32 x . bf16 y product to
// fp32 accuracy on the tensor cores.
__device__ __forceinline__ void split3(float x, float& hi, float& mid, float& lo) {
  hi = round_to<__nv_bfloat16>(x);
  float r = x - hi;
  mid = round_to<__nv_bfloat16>(r);
  lo = round_to<__nv_bfloat16>(r - mid);
}

// The fp32 values of an A fragment (x[i] = the register pair a[i]) scaled
// by `scale` and split into three bf16 terms: a[0..3] hi, a[4..7] mid,
// a[8..11] lo.
__device__ __forceinline__ void split3_fragment(const float2* x, float scale, uint32_t* a) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float h0, m0, l0, h1, m1, l1;
    split3(x[i].x * scale, h0, m0, l0);
    split3(x[i].y * scale, h1, m1, l1);
    a[i] = pack_bf16(h0, h1);
    a[4 + i] = pack_bf16(m0, m1);
    a[8 + i] = pack_bf16(l0, l1);
  }
}

// The A fragment (rows ra, rb; cols d..d+1 and d+8..d+9) of a row-major
// operand read straight from global memory, rows past the end as zeros:
// a[0..3] for bf16, or a[0..11] (three bf16 terms, split3_fragment) for
// fp32 scaled by `scale`.
template <typename TA>
__device__ __forceinline__ void load_a_fragment(const TA* pa, const TA* pb, bool va, bool vb,
                                                int d, float scale, uint32_t* a) {
  if constexpr (std::is_same<TA, __nv_bfloat16>::value) {
    a[0] = va ? ld32(pa + d) : 0u;
    a[1] = vb ? ld32(pb + d) : 0u;
    a[2] = va ? ld32(pa + d + 8) : 0u;
    a[3] = vb ? ld32(pb + d + 8) : 0u;
  } else {
    const float2 zero = make_float2(0.f, 0.f);
    const float2 x[4] = {va ? *reinterpret_cast<const float2*>(pa + d) : zero,
                         vb ? *reinterpret_cast<const float2*>(pb + d) : zero,
                         va ? *reinterpret_cast<const float2*>(pa + d + 8) : zero,
                         vb ? *reinterpret_cast<const float2*>(pb + d + 8) : zero};
    split3_fragment(x, scale, a);
  }
}

// Opt a kernel into more than 48 KB of dynamic shared memory (once per
// instantiation and size).
template <typename K> inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace ff

FF_EXPORT const char* ff_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

#define FF_TRY(expr)                        \
  do {                                      \
    cudaError_t _e = (expr);                \
    if (_e != cudaSuccess) return (int)_e;  \
  } while (0)
