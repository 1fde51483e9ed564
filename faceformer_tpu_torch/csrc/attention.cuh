// Per-(sequence, head) attention with the whole key side staged in shared
// memory. Shared by flash.cu (K2, flash forward) and the cross-attention of
// decode_step.cu (K4).
#pragma once

#include "common.cuh"

namespace ff {

constexpr int ATT_WARPS = 8;
constexpr int ATT_ROWS = 32;  // query rows per block: 4 per warp

template <typename TK> __host__ __device__ constexpr int kv_pad() { return 4 / (int)sizeof(TK); }

template <typename TK> inline size_t attention_smem_bytes(int Sk, int hd) {
  size_t ks = (size_t)Sk * (hd + kv_pad<TK>()) * sizeof(TK);
  size_t vs = (size_t)Sk * hd * sizeof(TK);
  ks = (ks + 15) / 16 * 16;
  vs = (vs + 15) / 16 * 16;
  return ks + vs + (size_t)ATT_WARPS * hd * 4 + (size_t)ATT_WARPS * Sk * 4;
}

// q (N, Sq, H, hd) of TQ; k, v (N, Sk, H, hd) of TK; bias (N, Sk) fp32
// additive; out (N, Sq, H, hd) of TQ; lse (N, Sq, H) fp32 or null.
//
// Scores: PRESCALE ? sum_d (q*scale)*k (decode_step.py's cross-attention)
//                  : (sum_d q*k)*scale (flash.py's _head_scores),
// then + bias, then NEG above the diagonal when causal. Softmax in fp32 as
// e = exp(s - max), p = e / sum(e); p is rounded to TQ before the product
// with v (flash.py rounds p to v's dtype; with TQ = float nothing rounds, as
// in decode_step.py's fp32 cross-attention). lse = max + log(sum(e)).
// DROP (training, flash.py:131-133): p becomes keep ? p * 1/(1 - rate) : 0
// after the softmax and before that rounding, with the keep mask of
// common.cuh; lse stays that of the scores. Without DROP the code is the
// dropout-free kernel unchanged.
//
// Grid (N * H, ceil(Sq / ATT_ROWS)), ATT_WARPS warps. K and V of the block's
// (sequence, head) sit in shared memory; one warp walks one query row at a
// time: lanes split the keys for the scores (rows padded to dodge bank
// conflicts) and split hd for the output.
template <typename TQ, typename TK, bool PRESCALE, bool DROP>
__global__ void __launch_bounds__(ATT_WARPS * 32)
attention_kernel(const TQ* __restrict__ q, const TK* __restrict__ k, const TK* __restrict__ v,
                 const float* __restrict__ bias, TQ* __restrict__ out, float* __restrict__ lse,
                 int Sq, int Sk, int H, int hd, float scale, int causal, Dropout drop) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int kstride = hd + kv_pad<TK>();
  size_t ks_bytes = ((size_t)Sk * kstride * sizeof(TK) + 15) / 16 * 16;
  size_t vs_bytes = ((size_t)Sk * hd * sizeof(TK) + 15) / 16 * 16;
  TK* Ks = reinterpret_cast<TK*>(smem);
  TK* Vs = reinterpret_cast<TK*>(smem + ks_bytes);
  float* qs = reinterpret_cast<float*>(smem + ks_bytes + vs_bytes);
  float* ps = qs + ATT_WARPS * hd;

  const int n = blockIdx.x / H, h = blockIdx.x % H, tile = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t E = (size_t)H * hd;

  for (int idx = threadIdx.x; idx < Sk * hd; idx += blockDim.x) {
    int j = idx / hd, d = idx % hd;
    size_t g = ((size_t)n * Sk + j) * E + (size_t)h * hd + d;
    Ks[j * kstride + d] = k[g];
    Vs[j * hd + d] = v[g];
  }
  __syncthreads();

  float* qw = qs + warp * hd;
  float* pw = ps + warp * Sk;
  const float* bias_n = bias + (size_t)n * Sk;
  const int row_end = min(Sq, (tile + 1) * ATT_ROWS);
  for (int i = tile * ATT_ROWS + warp; i < row_end; i += ATT_WARPS) {
    const size_t qoff = ((size_t)n * Sq + i) * E + (size_t)h * hd;
    for (int d = lane; d < hd; d += 32) {
      float x = to_f(q[qoff + d]);
      qw[d] = PRESCALE ? x * scale : x;
    }
    __syncwarp();

    float mx = -INFINITY;
    for (int j = lane; j < Sk; j += 32) {
      const TK* kj = Ks + j * kstride;
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s = fmaf(qw[d], to_f(kj[d]), s);
      if (!PRESCALE) s *= scale;
      s += bias_n[j];
      if (causal && j > i) s = NEG;
      pw[j] = s;
      mx = fmaxf(mx, s);
    }
    const float m = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < Sk; j += 32) {
      float e = expf(pw[j] - m);
      pw[j] = e;
      sum += e;
    }
    const float denom = warp_sum(sum);
    for (int j = lane; j < Sk; j += 32) {
      float p = pw[j] / denom;
      if constexpr (DROP) p = dropout_keep(drop, n, h, i, j) ? p * drop.scale : 0.f;
      pw[j] = round_to<TQ>(p);
    }
    if (lse != nullptr && lane == 0) lse[((size_t)n * Sq + i) * H + h] = m + logf(denom);
    __syncwarp();

    for (int d = lane; d < hd; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < Sk; ++j) acc = fmaf(pw[j], to_f(Vs[j * hd + d]), acc);
      out[qoff + d] = from_f<TQ>(acc);
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// Tensor-core path: bf16 K/V, hd = 64, Sk <= 256 (every call on the serve
// path). The same function and rounding points as attention_kernel, with
// the products on mma.sync:
//   - each warp owns 16 query rows and keeps their whole score rows
//     (KT 16-key tiles) in registers, so the softmax stays exact (one max,
//     one sum, p = e / sum), not online;
//   - TQ = bf16 (K2): q fragments come straight from global memory and p is
//     rounded to bf16 before the product with v, as flash.py does;
//   - TQ = float (K4's cross-attention, fp32 until its residual add): q and
//     p are split into three bf16 terms (split3), so both products keep
//     fp32 accuracy;
//   - K of the (sequence, head) sits in shared memory row-major, V
//     transposed, both padded to the tile with zeros; keys past Sk score
//     -inf, so they get probability exactly 0.
// Grid (N * H, ceil(Sq / 64)), 4 warps.
// ---------------------------------------------------------------------------
constexpr int TC_HD = 64;
constexpr int TC_WARPS = 4;
constexpr int TC_ROWS = 16 * TC_WARPS;
constexpr int TC_MAX_SK = 256;

template <int KT> constexpr size_t attention_tc_smem_bytes() {
  return (size_t)KT * 16 * (TC_HD + 8) * 2 + (size_t)TC_HD * (KT * 16 + 8) * 2 + KT * 16 * 4;
}

template <typename TQ, int KT, bool PRESCALE, bool DROP>
__global__ void __launch_bounds__(TC_WARPS * 32)
attention_tc_kernel(const TQ* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
                    TQ* __restrict__ out, float* __restrict__ lse, int Sq, int Sk, int H,
                    float scale, int causal, Dropout drop) {
  using bf16 = __nv_bfloat16;
  constexpr bool F32 = std::is_same<TQ, float>::value;
  constexpr int TERMS = F32 ? 3 : 1;
  constexpr int SKP = KT * 16, KSTR = TC_HD + 8, VSTR = SKP + 8;
  static_assert(F32 || !PRESCALE, "bf16 queries are scaled after the product");
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);  // [SKP][KSTR]
  bf16* Vt = Ks + SKP * KSTR;                 // [TC_HD][VSTR]
  float* bs = reinterpret_cast<float*>(Vt + TC_HD * VSTR);

  const int n = blockIdx.x / H, h = blockIdx.x % H;
  const size_t E = (size_t)H * TC_HD;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tig = lane & 3;

  for (int c = tid; c < SKP * (TC_HD / 8); c += blockDim.x) {
    const int j = c / (TC_HD / 8), d0 = (c % (TC_HD / 8)) * 8;
    uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
    if (j < Sk) {
      const size_t gi = ((size_t)n * Sk + j) * E + (size_t)h * TC_HD + d0;
      kv = *reinterpret_cast<const uint4*>(k + gi);
      vv = *reinterpret_cast<const uint4*>(v + gi);
    }
    *reinterpret_cast<uint4*>(Ks + j * KSTR + d0) = kv;
    const bf16* ve = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
    for (int i = 0; i < 8; ++i) Vt[(d0 + i) * VSTR + j] = ve[i];
  }
  for (int j = tid; j < SKP; j += blockDim.x)
    bs[j] = j < Sk ? bias[(size_t)n * Sk + j] : -INFINITY;
  __syncthreads();

  const int ra = blockIdx.y * TC_ROWS + warp * 16 + g, rb = ra + 8;
  if (ra - g >= Sq) return;
  const bool va = ra < Sq, vb = rb < Sq;
  const TQ* qa = q + ((size_t)n * Sq + ra) * E + (size_t)h * TC_HD;
  const TQ* qb = q + ((size_t)n * Sq + rb) * E + (size_t)h * TC_HD;

  // scores: s[nt] is the 16x8 tile of keys nt*8 .. nt*8+7
  float s[2 * KT][4];
#pragma unroll
  for (int nt = 0; nt < 2 * KT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < TC_HD / 16; ++ks) {
    uint32_t a[4 * TERMS];
    load_a_fragment(qa, qb, va, vb, ks * 16 + tig * 2, PRESCALE ? scale : 1.f, a);
#pragma unroll
    for (int nt = 0; nt < 2 * KT; ++nt) {
      const bf16* kr = Ks + (nt * 8 + g) * KSTR + ks * 16 + tig * 2;
      const uint32_t b[2] = {ld32(kr), ld32(kr + 8)};
#pragma unroll
      for (int t = 0; t < TERMS; ++t) mma_bf16_16816(s[nt], a + 4 * t, b);
    }
  }

  // scale, bias, causal mask, then the exact softmax over each row; a row's
  // values sit in the 4 lanes of one quad
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < 2 * KT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = nt * 8 + tig * 2 + (i & 1), row = i < 2 ? ra : rb;
      float x = (PRESCALE ? s[nt][i] : s[nt][i] * scale) + bs[j];
      if (causal && j > row && j < Sk) x = NEG;
      s[nt][i] = x;
      mx[i / 2] = fmaxf(mx[i / 2], x);
    }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r)
    for (int off = 1; off < 4; off <<= 1)
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], off));
#pragma unroll
  for (int nt = 0; nt < 2 * KT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[nt][i] = expf(s[nt][i] - mx[i / 2]);
      sum[i / 2] += s[nt][i];
    }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    for (int off = 1; off < 4; off <<= 1) sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], off);
  if (lse != nullptr && tig == 0) {
    if (va) lse[((size_t)n * Sq + ra) * H + h] = mx[0] + logf(sum[0]);
    if (vb) lse[((size_t)n * Sq + rb) * H + h] = mx[1] + logf(sum[1]);
  }

  // out = p . v: the C fragments of key tiles 2kt, 2kt+1 are the A fragment
  // of the kt-th 16-key step
  float o[TC_HD / 8][4];
#pragma unroll
  for (int dt = 0; dt < TC_HD / 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    // p pairs (p[2i], p[2i+1]) are the register pairs a[i] of the fragment
    float p[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      p[i] = s[2 * kt][i] / sum[i / 2];
      p[4 + i] = s[2 * kt + 1][i] / sum[i / 2];
    }
    if constexpr (DROP) {
      // p[4t + 2r], p[4t + 2r + 1]: key tile 2kt + t, row r, keys j, j + 1
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        bool keep[4];
        dropout_keep_rows(drop, n, h, ra, rb, (2 * kt + t) * 8 + tig * 2, tig, keep);
#pragma unroll
        for (int i = 0; i < 4; ++i) p[4 * t + i] = keep[i] ? p[4 * t + i] * drop.scale : 0.f;
      }
    }
    uint32_t a[4 * TERMS];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (F32) {
        float h0, m0, l0, h1, m1, l1;
        split3(p[2 * i], h0, m0, l0);
        split3(p[2 * i + 1], h1, m1, l1);
        a[i] = pack_bf16(h0, h1);
        a[4 + i] = pack_bf16(m0, m1);
        a[8 + i] = pack_bf16(l0, l1);
      } else {
        a[i] = pack_bf16(p[2 * i], p[2 * i + 1]);
      }
    }
#pragma unroll
    for (int dt = 0; dt < TC_HD / 8; ++dt) {
      const bf16* vr = Vt + (dt * 8 + g) * VSTR + kt * 16 + tig * 2;
      const uint32_t b[2] = {ld32(vr), ld32(vr + 8)};
#pragma unroll
      for (int t = 0; t < TERMS; ++t) mma_bf16_16816(o[dt], a + 4 * t, b);
    }
  }

  TQ* oa = out + ((size_t)n * Sq + ra) * E + (size_t)h * TC_HD;
  TQ* ob = out + ((size_t)n * Sq + rb) * E + (size_t)h * TC_HD;
#pragma unroll
  for (int dt = 0; dt < TC_HD / 8; ++dt) {
    const int d = dt * 8 + tig * 2;
    if constexpr (F32) {
      if (va) *reinterpret_cast<float2*>(oa + d) = make_float2(o[dt][0], o[dt][1]);
      if (vb) *reinterpret_cast<float2*>(ob + d) = make_float2(o[dt][2], o[dt][3]);
    } else {
      if (va) *reinterpret_cast<uint32_t*>(oa + d) = pack_bf16(o[dt][0], o[dt][1]);
      if (vb) *reinterpret_cast<uint32_t*>(ob + d) = pack_bf16(o[dt][2], o[dt][3]);
    }
  }
}

template <typename TQ, int KT, bool PRESCALE, bool DROP>
inline cudaError_t launch_attention_tc(const TQ* q, const __nv_bfloat16* k,
                                       const __nv_bfloat16* v, const float* bias, TQ* out,
                                       float* lse, int N, int Sq, int Sk, int H, float scale,
                                       int causal, Dropout drop, cudaStream_t stream) {
  constexpr size_t smem = attention_tc_smem_bytes<KT>();
  auto kernel = attention_tc_kernel<TQ, KT, PRESCALE, DROP>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(N * H, (Sq + TC_ROWS - 1) / TC_ROWS);
  kernel<<<grid, TC_WARPS * 32, smem, stream>>>(q, k, v, bias, out, lse, Sq, Sk, H, scale,
                                                causal, drop);
  return cudaGetLastError();
}

// The tensor-core path where it applies, else the CUDA-core kernel above.
// DROP is instantiated by the flash forward only; the decode step's
// cross-attention never drops.
template <typename TQ, typename TK, bool PRESCALE, bool DROP = false>
inline cudaError_t launch_attention(const TQ* q, const TK* k, const TK* v, const float* bias,
                                    TQ* out, float* lse, int N, int Sq, int Sk, int H, int hd,
                                    float scale, int causal, cudaStream_t stream,
                                    Dropout drop = Dropout()) {
  if constexpr (std::is_same<TK, __nv_bfloat16>::value &&
                (std::is_same<TQ, float>::value || !PRESCALE)) {
    if (hd == TC_HD && Sk <= TC_MAX_SK) {
      const int kt = (Sk + 15) / 16;
#define FF_ATT_TC(KT) \
  return launch_attention_tc<TQ, KT, PRESCALE, DROP>(q, k, v, bias, out, lse, N, Sq, Sk, H, \
                                                     scale, causal, drop, stream)
      if (kt <= 1) FF_ATT_TC(1);
      if (kt <= 2) FF_ATT_TC(2);
      if (kt <= 3) FF_ATT_TC(3);
      if (kt <= 4) FF_ATT_TC(4);
      if (kt <= 8) FF_ATT_TC(8);
      if (kt <= 14) FF_ATT_TC(14);
      FF_ATT_TC(16);
#undef FF_ATT_TC
    }
  }
  size_t smem = attention_smem_bytes<TK>(Sk, hd);
  auto kernel = attention_kernel<TQ, TK, PRESCALE, DROP>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(N * H, (Sq + ATT_ROWS - 1) / ATT_ROWS);
  kernel<<<grid, ATT_WARPS * 32, smem, stream>>>(q, k, v, bias, out, lse, Sq, Sk, H, hd, scale,
                                                 causal, drop);
  return cudaGetLastError();
}

}  // namespace ff
