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
// Tensor-core path: bf16 K and V, hd = 64, Sk <= 256 (every call on the
// main paths). TQ = bf16 is K2's forward; TQ = float is K4's fp32
// cross-attention. The same function and rounding points as
// attention_kernel, with the products on mma.sync:
//   - each warp owns 16 query rows of a 64-row tile and keeps their whole
//     score rows (KT 16-key tiles) in registers, so the softmax stays exact
//     (one max, one sum), not online;
//   - TQ = bf16: p is rounded to bf16 before the product with v, as
//     flash.py does; TQ = float: q and p are split into three bf16 terms
//     (split3), so both products keep fp32 accuracy;
//   - keys past Sk: K and V rows zero, bias -inf, so p is exactly 0 there;
//   - p = e * RN(1 / sum) rather than e / sum: an IEEE division per
//     element, inlined 2 * KT * 4 times with its slow path, took two
//     thirds of the call; the two agree to 2^-23 relative before p is
//     rounded, and the Pallas kernel's division on the TPU is not IEEE
//     either. Skipping masked key steps by warp votes was slower than
//     doing their products, so the code stays straight-line.
//
// Data path. Every tile sits in shared memory row-major, as it lies in
// device memory, rows padded to TC_STR elements (144 B bf16, 288 B fp32)
// so that the eight rows of one ldmatrix, or the eight rows a quarter-warp
// reads, fall on distinct banks. Everything arrives by 16-byte cp.async
// (4 B for the bias): q's A fragments come by ldmatrix (bf16) or 8-byte
// loads and split3 (fp32), K's B fragments by ldmatrix, V's by
// ldmatrix.trans; nothing is transposed by scalar stores. A 2-stage ring
// overlaps the copy of the next item with the products of the current
// one; one __syncthreads per item hands a stage back. A warp stages its
// 16 output rows in the q rows it has consumed and writes them out with
// 16-byte stores (whole 128-byte rows for bf16). lse is (N, Sq, H): one
// row's value for one head is 4 B of a 32-B sector whose other 28 B belong
// to the other heads' blocks, which run in the same wave, so it goes out
// as one 4-byte store per row and L2 merges the sector.
//
// Two walks, both chosen from the card's resident blocks (SMs x blocks an
// SM holds at this shared memory), so that one wave covers the call:
//   - tiles (Sq > 64): grid (N * H, splits); a block copies K, V and the
//     bias row of its (sequence, head) into shared memory ONCE, then walks
//     the query tiles y, y + splits, ... through the ring (splits =
//     resident blocks / pairs, at least 1, at most one a tile);
//   - pairs (Sq <= 64, one tile a pair: the decoder's 37-40-row
//     sequences): grid (min(N * H, resident blocks)); a block walks pairs
//     x, x + gridDim.x, ..., and each ring stage holds a whole pair's q,
//     K, V and bias, so the next pair's copy runs under this pair's
//     products instead of each block waiting for its own key side.
// ---------------------------------------------------------------------------
constexpr int TC_HD = 64;
constexpr int TC_WARPS = 4;
constexpr int TC_ROWS = 16 * TC_WARPS;  // query rows of a tile
constexpr int TC_MAX_SK = 256;
constexpr int TC_STR = TC_HD + 8;       // padded row of a staged tile, in elements

// K, V (bf16) and the bias row (fp32) of one (sequence, head)
template <int KT> __host__ __device__ constexpr size_t tc_kv_bytes() {
  return (size_t)2 * KT * 16 * TC_STR * 2 + (size_t)KT * 16 * 4;
}
template <typename TQ> __host__ __device__ constexpr size_t tc_q_bytes() {
  return (size_t)TC_ROWS * TC_STR * sizeof(TQ);
}
// dynamic shared memory of the pairs walk (2 stages of q, K, V and bias) or
// of the tiles walk (K, V and bias, then 2 stages of q)
template <typename TQ, int KT> __host__ __device__ constexpr size_t tc_smem_bytes(bool pairs) {
  return pairs ? 2 * (tc_q_bytes<TQ>() + tc_kv_bytes<KT>())
               : tc_kv_bytes<KT>() + 2 * tc_q_bytes<TQ>();
}
template <typename TQ, int KT> constexpr size_t tc_smem_max() {
  return tc_smem_bytes<TQ, KT>(true) > tc_smem_bytes<TQ, KT>(false)
             ? tc_smem_bytes<TQ, KT>(true)
             : tc_smem_bytes<TQ, KT>(false);
}

// Start the copy of query rows i0 .. i0 + TC_ROWS - 1 of (n, h) into Qs;
// rows past Sq are zero-filled. Every thread of the block calls it.
template <typename TQ>
__device__ __forceinline__ void tc_stage_q(TQ* Qs, const TQ* q, int n, int h, int H, int Sq,
                                           int i0) {
  constexpr int C = 16 / sizeof(TQ), CPR = TC_HD / C;  // elements a chunk, chunks a row
  const size_t E = (size_t)H * TC_HD;
  for (int c = threadIdx.x; c < TC_ROWS * CPR; c += blockDim.x) {
    const int r = c / CPR, d0 = (c % CPR) * C;
    const bool ok = i0 + r < Sq;
    const size_t gi = ok ? ((size_t)n * Sq + i0 + r) * E + (size_t)h * TC_HD + d0 : 0;
    cp_async16(Qs + r * TC_STR + d0, q + gi, ok);
  }
}

// Start the copy of K, V and the bias row of (n, h), padded to KT * 16
// keys: K and V rows past Sk zero-filled, their bias -inf.
template <int KT>
__device__ __forceinline__ void tc_stage_kv(unsigned char* kv, const __nv_bfloat16* k,
                                            const __nv_bfloat16* v, const float* bias, int n,
                                            int h, int H, int Sk) {
  constexpr int SKP = KT * 16;
  auto Ks = reinterpret_cast<__nv_bfloat16*>(kv);
  auto Vs = Ks + SKP * TC_STR;
  auto bs = reinterpret_cast<float*>(Vs + SKP * TC_STR);
  const size_t E = (size_t)H * TC_HD;
  for (int c = threadIdx.x; c < SKP * (TC_HD / 8); c += blockDim.x) {
    const int j = c / (TC_HD / 8), d0 = (c % (TC_HD / 8)) * 8;
    const bool ok = j < Sk;
    const size_t gi = ok ? ((size_t)n * Sk + j) * E + (size_t)h * TC_HD + d0 : 0;
    cp_async16(Ks + j * TC_STR + d0, k + gi, ok);
    cp_async16(Vs + j * TC_STR + d0, v + gi, ok);
  }
  for (int j = threadIdx.x; j < SKP; j += blockDim.x) {
    if (j < Sk)
      cp_async4(bs + j, bias + (size_t)n * Sk + j, true);
    else
      bs[j] = -INFINITY;
  }
}

// The A fragment of 16 staged rows (Qw = their first row), columns c0 ..
// c0 + 15: by ldmatrix for bf16; for fp32 by 8-byte loads, scaled by
// `scale` and split into three bf16 terms (split3_fragment).
template <typename TQ>
__device__ __forceinline__ void tc_a_fragment(const TQ* Qw, int c0, int lane, float scale,
                                              uint32_t* a) {
  if constexpr (std::is_same<TQ, __nv_bfloat16>::value) {
    const int lr = lane & 7, lm = lane >> 3;
    ldmatrix_x4(a, Qw + (lr + (lm & 1) * 8) * TC_STR + c0 + (lm >> 1) * 8);
  } else {
    const int g = lane >> 2, c = c0 + (lane & 3) * 2;
    const float2 x[4] = {*reinterpret_cast<const float2*>(Qw + g * TC_STR + c),
                         *reinterpret_cast<const float2*>(Qw + (g + 8) * TC_STR + c),
                         *reinterpret_cast<const float2*>(Qw + g * TC_STR + c + 8),
                         *reinterpret_cast<const float2*>(Qw + (g + 8) * TC_STR + c + 8)};
    split3_fragment(x, scale, a);
  }
}

template <typename TQ, int KT, bool PRESCALE, bool DROP>
__global__ void __launch_bounds__(TC_WARPS * 32)
attention_tc_kernel(const TQ* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
                    TQ* __restrict__ out, float* __restrict__ lse, int N, int Sq, int Sk, int H,
                    float scale, int causal, Dropout drop) {
  using bf16 = __nv_bfloat16;
  constexpr bool F32 = std::is_same<TQ, float>::value;
  constexpr int TERMS = F32 ? 3 : 1;
  constexpr int SKP = KT * 16, NT = 2 * KT;
  constexpr size_t QB = tc_q_bytes<TQ>(), KVB = tc_kv_bytes<KT>();
  static_assert(F32 || !PRESCALE, "bf16 queries are scaled after the product");
  extern __shared__ __align__(16) unsigned char smem[];

  const size_t E = (size_t)H * TC_HD;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tig = lane & 3;
  // ldmatrix row/column offsets of this lane: transposed B (a_), B
  // fragments of two 8-wide n-tiles from an [n][k] tile (b_)
  const int lr = lane & 7, lm = lane >> 3;
  const int a_row = lr + (lm & 1) * 8, a_col = (lm >> 1) * 8;
  const int b_row = lr + (lm >> 1) * 8, b_col = (lm & 1) * 8;

  // the block's items: pairs first, first + step, ... (pairs walk) or
  // tiles first, first + step, ... of pair blockIdx.x (tiles walk)
  const bool walk_pairs = Sq <= TC_ROWS;
  const int first = walk_pairs ? blockIdx.x : blockIdx.y;
  const int step = walk_pairs ? gridDim.x : gridDim.y;
  const int count = walk_pairs ? N * H : (Sq + TC_ROWS - 1) / TC_ROWS;
  const size_t stage = walk_pairs ? QB + KVB : QB;
  unsigned char* ring = walk_pairs ? smem : smem + KVB;
  auto fetch = [&](int w, unsigned char* st) {
    const int p = walk_pairs ? w : (int)blockIdx.x;
    tc_stage_q(reinterpret_cast<TQ*>(st), q, p / H, p % H, H, Sq, walk_pairs ? 0 : w * TC_ROWS);
    if (walk_pairs) tc_stage_kv<KT>(st + QB, k, v, bias, p / H, p % H, H, Sk);
  };
  if (!walk_pairs) tc_stage_kv<KT>(smem, k, v, bias, blockIdx.x / H, blockIdx.x % H, H, Sk);
  if (first < count) fetch(first, ring);
  cp_async_commit();

  for (int it = 0, w = first; w < count; ++it, w += step) {
    cp_async_wait<0>();
    __syncthreads();  // item w has landed everywhere; the other stage is free
    if (w + step < count) fetch(w + step, ring + ((it + 1) & 1) * stage);
    cp_async_commit();

    unsigned char* st = ring + (it & 1) * stage;
    TQ* Qs = reinterpret_cast<TQ*>(st);
    const bf16* Ks = reinterpret_cast<const bf16*>(walk_pairs ? st + QB : smem);
    const bf16* Vs = Ks + SKP * TC_STR;
    const float* bs = reinterpret_cast<const float*>(Vs + SKP * TC_STR);
    const int p = walk_pairs ? w : (int)blockIdx.x, n = p / H, h = p % H;
    const int r0 = warp * 16, i0 = (walk_pairs ? 0 : w * TC_ROWS) + r0;  // the warp's rows
    if (i0 >= Sq) continue;
    const int ra = i0 + g, rb = ra + 8;
    const bool va = ra < Sq, vb = rb < Sq;

    // scores: s[nt] is the 16x8 tile of keys nt*8 .. nt*8+7
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < TC_HD / 16; ++ks) {
      uint32_t a[4 * TERMS];
      tc_a_fragment(Qs + r0 * TC_STR, ks * 16, lane, PRESCALE ? scale : 1.f, a);
#pragma unroll
      for (int np = 0; np < KT; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, Ks + (np * 16 + b_row) * TC_STR + ks * 16 + b_col);
#pragma unroll
        for (int t = 0; t < TERMS; ++t) mma_bf16_16816(s[2 * np], a + 4 * t, b);
#pragma unroll
        for (int t = 0; t < TERMS; ++t) mma_bf16_16816(s[2 * np + 1], a + 4 * t, b + 2);
      }
    }

    // scale, bias, causal mask, then the exact softmax over each row; a
    // row's values sit in the 4 lanes of one quad
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
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
    for (int nt = 0; nt < NT; ++nt)
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

    // out = p . v: the C fragments of key tiles 2kt, 2kt+1 are the A
    // fragment of the kt-th 16-key step; V's B fragments by ldmatrix.trans
    const float inv[2] = {1.f / sum[0], 1.f / sum[1]};
    float o[TC_HD / 8][4];
#pragma unroll
    for (int dt = 0; dt < TC_HD / 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      // p pairs (p[2i], p[2i+1]) are the register pairs a[i] of the fragment
      float p[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = s[2 * kt][i] * inv[i / 2];
        p[4 + i] = s[2 * kt + 1][i] * inv[i / 2];
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
      if constexpr (F32) {
        const float2 x[4] = {make_float2(p[0], p[1]), make_float2(p[2], p[3]),
                             make_float2(p[4], p[5]), make_float2(p[6], p[7])};
        split3_fragment(x, 1.f, a);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = pack_bf16(p[2 * i], p[2 * i + 1]);
      }
#pragma unroll
      for (int d2 = 0; d2 < TC_HD / 16; ++d2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, Vs + (kt * 16 + a_row) * TC_STR + d2 * 16 + a_col);
#pragma unroll
        for (int t = 0; t < TERMS; ++t) mma_bf16_16816(o[2 * d2], a + 4 * t, b);
#pragma unroll
        for (int t = 0; t < TERMS; ++t) mma_bf16_16816(o[2 * d2 + 1], a + 4 * t, b + 2);
      }
    }

    // the output rows go through the warp's own (consumed) q rows, then
    // out as 16-byte stores
    TQ* Os = Qs + r0 * TC_STR;
    __syncwarp();
#pragma unroll
    for (int dt = 0; dt < TC_HD / 8; ++dt) {
      const int d = dt * 8 + tig * 2;
      if constexpr (F32) {
        *reinterpret_cast<float2*>(Os + g * TC_STR + d) = make_float2(o[dt][0], o[dt][1]);
        *reinterpret_cast<float2*>(Os + (g + 8) * TC_STR + d) = make_float2(o[dt][2], o[dt][3]);
      } else {
        *reinterpret_cast<uint32_t*>(Os + g * TC_STR + d) = pack_bf16(o[dt][0], o[dt][1]);
        *reinterpret_cast<uint32_t*>(Os + (g + 8) * TC_STR + d) = pack_bf16(o[dt][2], o[dt][3]);
      }
    }
    __syncwarp();
    constexpr int C = 16 / sizeof(TQ), CPR = TC_HD / C;
#pragma unroll
    for (int c = lane; c < 16 * CPR; c += 32) {
      const int r = c / CPR, d0 = (c % CPR) * C;
      if (i0 + r < Sq)
        *reinterpret_cast<uint4*>(out + ((size_t)n * Sq + i0 + r) * E + (size_t)h * TC_HD + d0) =
            *reinterpret_cast<const uint4*>(Os + r * TC_STR + d0);
    }
  }
  cp_async_wait<0>();
}

template <typename TQ, int KT, bool PRESCALE, bool DROP>
inline cudaError_t launch_attention_tc(const TQ* q, const __nv_bfloat16* k,
                                       const __nv_bfloat16* v, const float* bias, TQ* out,
                                       float* lse, int N, int Sq, int Sk, int H, float scale,
                                       int causal, Dropout drop, cudaStream_t stream) {
  auto kernel = attention_tc_kernel<TQ, KT, PRESCALE, DROP>;
  cudaError_t e = allow_smem(kernel, tc_smem_max<TQ, KT>());
  if (e != cudaSuccess) return e;
  const bool walk_pairs = Sq <= TC_ROWS;
  const size_t smem = tc_smem_bytes<TQ, KT>(walk_pairs);
  int dev = 0, sms = 0, per_sm = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, TC_WARPS * 32, smem);
  if (e != cudaSuccess) return e;
  const int pairs = N * H, tiles = (Sq + TC_ROWS - 1) / TC_ROWS;
  const int resident = sms * per_sm > 0 ? sms * per_sm : 1;
  const int splits = resident / pairs < 1 ? 1 : resident / pairs > tiles ? tiles : resident / pairs;
  const dim3 grid = walk_pairs ? dim3(pairs < resident ? pairs : resident) : dim3(pairs, splits);
  kernel<<<grid, TC_WARPS * 32, smem, stream>>>(q, k, v, bias, out, lse, N, Sq, Sk, H, scale,
                                                causal, drop);
  return cudaGetLastError();
}

// The key tiles of the instantiation that takes Sk on the tensor-core path.
inline int tc_key_tiles(int Sk) {
  const int kt = (Sk + 15) / 16;
  return kt <= 1 ? 1 : kt <= 4 ? kt : kt <= 8 ? 8 : kt <= 14 ? 14 : 16;
}

// The most dynamic shared memory the tensor-core kernel takes at Sk (the
// larger of its two walks).
template <typename TQ> inline size_t tc_smem_for(int Sk) {
  switch (tc_key_tiles(Sk)) {
    case 1: return tc_smem_max<TQ, 1>();
    case 2: return tc_smem_max<TQ, 2>();
    case 3: return tc_smem_max<TQ, 3>();
    case 4: return tc_smem_max<TQ, 4>();
    case 8: return tc_smem_max<TQ, 8>();
    case 14: return tc_smem_max<TQ, 14>();
    default: return tc_smem_max<TQ, 16>();
  }
}

// The tensor-core path where it applies (bf16 K/V at hd = 64, Sk <= 256;
// bf16 queries scaled after the product, or fp32 queries), else the
// CUDA-core kernel above. DROP is instantiated by the flash forward only;
// the decode step's cross-attention never drops.
template <typename TQ, typename TK, bool PRESCALE>
constexpr bool has_tc_path() {
  return std::is_same<TK, __nv_bfloat16>::value && (std::is_same<TQ, float>::value || !PRESCALE);
}
inline bool takes_tc(int Sk, int hd) { return hd == TC_HD && Sk <= TC_MAX_SK; }

template <typename TQ, typename TK, bool PRESCALE, bool DROP = false>
inline cudaError_t launch_attention(const TQ* q, const TK* k, const TK* v, const float* bias,
                                    TQ* out, float* lse, int N, int Sq, int Sk, int H, int hd,
                                    float scale, int causal, cudaStream_t stream,
                                    Dropout drop = Dropout()) {
  if constexpr (has_tc_path<TQ, TK, PRESCALE>()) {
    if (takes_tc(Sk, hd)) {
#define FF_ATT_TC(KT)                                                                         \
  return launch_attention_tc<TQ, KT, PRESCALE, DROP>(q, k, v, bias, out, lse, N, Sq, Sk, H,  \
                                                     scale, causal, drop, stream)
      switch (tc_key_tiles(Sk)) {
        case 1: FF_ATT_TC(1);
        case 2: FF_ATT_TC(2);
        case 3: FF_ATT_TC(3);
        case 4: FF_ATT_TC(4);
        case 8: FF_ATT_TC(8);
        case 14: FF_ATT_TC(14);
        default: FF_ATT_TC(16);
      }
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
