// K2's key-tiled tensor-core forward: bf16 at hd = 64 past the whole-row
// tensor-core kernel's TC_MAX_SK keys (the flat model's 512-token decoder
// self-attention, the reference engine's 512-key prefix buffer, anything up
// to the JAX kernel's ~2,000 keys). The same function and rounding points
// as attention_tc_kernel (attention.cuh) and as _fwd_kernel
// (faceformer_tpu/ops/flash.py:118-137), with the key side walked in tiles.
//
// What bounds it here: at the flat decoder's (32, 512) causal call the
// inputs and outputs are 67.7 MB (0.020 ms at 3.35 TB/s) against 12.9
// GFLOP over three products (0.013 ms at the dense bf16 peak), so bytes in
// principle; in practice the instruction throughput of mma.sync, the
// exponentials and the Philox draws of dropout (one call per row and 4-key
// group).
//
// Design:
//   - a block owns one (sequence, head) and one 64-row query tile, 4 warps
//     of 16 rows (TC_ROWS). q's A fragments come into registers once by
//     ldmatrix and stay there for both passes;
//   - key tiles of TT_KEYS = 64 keys (four 16-key steps of m16n8k16) come
//     through a TT_STAGES-deep cp.async ring, each stage holding K, V and
//     the tile's bias slice, rows padded to TC_STR as in attention.cuh (no
//     bank conflicts for ldmatrix). K's B fragments come by ldmatrix, V's
//     by ldmatrix.trans. Keys past Sk get zero K and V rows and a -inf
//     bias, so their p is exactly 0;
//   - pass 1 computes s = (q . k^T) * scale + bias on mma.sync, fills the
//     causally masked cells with the float32 minimum, and keeps each row's
//     running max m and its sum l of exp(s - m), rescaled when m grows
//     (each lane sums its own keys; the quad's sums meet once at the end).
//     lse = m + log(l);
//   - pass 2 walks the same tiles again (one linear walk of the ring: pass
//     2's first tile arrives under pass 1's last), recomputes s and forms
//     p = exp(s - m) * (1 / l), drops it with the keep bits of the GLOBAL
//     (i, j) (dropout_keep_rows: one Philox call per row and 4-key group),
//     multiplies by the dropout scale and rounds it to bf16 as the A
//     fragment of p . v. O accumulates in fp32 registers (16 x 64 a warp)
//     and leaves through the warp's consumed q rows as 16-byte stores.
//     Online rescaling of O would round another quantity to bf16 than the
//     reference does (e / denom, before p . v); the second q . k^T keeps
//     its arithmetic and is cheap on the tensor cores;
//   - p is exp(s - m) / l and not exp(s - lse): in a row whose every key
//     is masked, m is the float32 minimum, lse rounds back to it, and
//     exp(s - lse) would be 1 where the reference's e / denom is 1 / Sk;
//   - causal: the key tiles past the query tile's last row are skipped in
//     both passes (their p is exactly 0) and only the diagonal tile is
//     masked element-wise; the skip holds only while every row keeps one
//     live key in the visited tiles, so a block whose first row sees no
//     live key among the first 128 walks every tile, as a row whose keys
//     are all masked spreads its p over all of them. The grid runs the
//     late (heavy) query tiles first, so the causal triangle leaves no
//     tail of idle SMs.
#pragma once

#include "attention.cuh"

namespace ff {

constexpr int TT_KEYS = 64;   // keys a tile: four 16-key mma steps
constexpr int TT_STAGES = 2;  // depth of the key-tile ring
// K and V (bf16, rows of TC_STR) and the bias slice (fp32) of one key tile
constexpr size_t TT_STAGE_BYTES = (size_t)2 * TT_KEYS * TC_STR * 2 + (size_t)TT_KEYS * 4;
constexpr size_t TT_SMEM_BYTES = tc_q_bytes<__nv_bfloat16>() + TT_STAGES * TT_STAGE_BYTES;

// Start the copy of keys j0 .. j0 + TT_KEYS - 1 of (n, h) into stage st:
// K, V when with_v, and their bias; keys past Sk get zero rows and a -inf
// bias. Every thread of the block calls it.
__device__ __forceinline__ void tt_stage(unsigned char* st, const __nv_bfloat16* k,
                                         const __nv_bfloat16* v, const float* bias, int n,
                                         int h, int H, int Sk, int j0, bool with_v) {
  auto Ks = reinterpret_cast<__nv_bfloat16*>(st);
  auto Vs = Ks + TT_KEYS * TC_STR;
  auto bs = reinterpret_cast<float*>(Vs + TT_KEYS * TC_STR);
  const size_t E = (size_t)H * TC_HD;
  for (int c = threadIdx.x; c < TT_KEYS * (TC_HD / 8); c += blockDim.x) {
    const int jj = c / (TC_HD / 8), d0 = (c % (TC_HD / 8)) * 8;
    const bool ok = j0 + jj < Sk;
    const size_t gi = ok ? ((size_t)n * Sk + j0 + jj) * E + (size_t)h * TC_HD + d0 : 0;
    cp_async16(Ks + jj * TC_STR + d0, k + gi, ok);
    if (with_v) cp_async16(Vs + jj * TC_STR + d0, v + gi, ok);
  }
  for (int jj = threadIdx.x; jj < TT_KEYS; jj += blockDim.x) {
    if (j0 + jj < Sk)
      cp_async4(bs + jj, bias + (size_t)n * Sk + j0 + jj, true);
    else
      bs[jj] = -INFINITY;
  }
}

// Grid (N * H, ceil(Sq / TC_ROWS)), TC_WARPS warps; q, k, v, out bf16
// (N, S, H, 64), bias (N, Sk) fp32, lse (N, Sq, H) fp32.
template <bool DROP>
__global__ void __launch_bounds__(TC_WARPS * 32)
attention_tiled_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
                          __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int Sq,
                          int Sk, int H, float scale, int causal, Dropout drop) {
  using bf16 = __nv_bfloat16;
  constexpr int NT = TT_KEYS / 8;  // 8-key n-tiles of a key tile
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  unsigned char* ring = smem + tc_q_bytes<bf16>();

  const int n = blockIdx.x / H, h = blockIdx.x % H;
#ifdef FF_LIGHT_FIRST  // tools/time_key_tiles.py times the other order
  const int i0 = blockIdx.y * TC_ROWS;
#else
  const int i0 = (gridDim.y - 1 - blockIdx.y) * TC_ROWS;  // late (heavy) tiles first
#endif
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int lr = lane & 7, lm = lane >> 3;
  const int a_row = lr + (lm & 1) * 8, a_col = (lm >> 1) * 8;  // ldmatrix.trans of V
  const int b_row = lr + (lm >> 1) * 8, b_col = (lm & 1) * 8;  // ldmatrix of K
  const int r0 = warp * 16, ra = i0 + r0 + g, rb = ra + 8;     // the warp's and lane's rows
  const size_t E = (size_t)H * TC_HD;

  // the key tiles walked: under the causal mask those up to the query
  // tile's last row, if a live key j <= i0 keeps every row's max finite
  int tiles = (Sk + TT_KEYS - 1) / TT_KEYS;
  if (causal) {
    const int probe = min(min(i0 + 1, Sk), (int)blockDim.x);
    if (__syncthreads_or(tid < probe && bias[(size_t)n * Sk + tid] > NEG))
      tiles = (min(Sk, i0 + TC_ROWS) + TT_KEYS - 1) / TT_KEYS;
  }
  const int items = 2 * tiles;  // pass 1's tiles, then pass 2's
  auto fetch = [&](int w) {
    const bool pass2 = w >= tiles;
    tt_stage(ring + (w % TT_STAGES) * TT_STAGE_BYTES, k, v, bias, n, h, H, Sk,
             (pass2 ? w - tiles : w) * TT_KEYS, pass2);
  };
  tc_stage_q(Qs, q, n, h, H, Sq, i0);
#pragma unroll
  for (int w = 0; w < TT_STAGES - 1; ++w) {
    if (w < items) fetch(w);
    cp_async_commit();
  }

  uint32_t qa[TC_HD / 16][4];
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f}, inv[2] = {0.f, 0.f};
  float o[TC_HD / 8][4];
#pragma unroll
  for (int dt = 0; dt < TC_HD / 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;

  for (int w = 0; w < items; ++w) {
    cp_async_wait<TT_STAGES - 2>();
    __syncthreads();  // item w has landed everywhere; stage (w - 1) is free
    if (w + TT_STAGES - 1 < items) fetch(w + TT_STAGES - 1);
    cp_async_commit();
    if (w == 0) {
#pragma unroll
      for (int ks = 0; ks < TC_HD / 16; ++ks)
        tc_a_fragment(Qs + r0 * TC_STR, ks * 16, lane, 1.f, qa[ks]);
    }
    const bool pass2 = w >= tiles;
    const int j0 = (pass2 ? w - tiles : w) * TT_KEYS;
    const unsigned char* st = ring + (w % TT_STAGES) * TT_STAGE_BYTES;
    const bf16* Ks = reinterpret_cast<const bf16*>(st);
    const bf16* Vs = Ks + TT_KEYS * TC_STR;
    const float* bs = reinterpret_cast<const float*>(Vs + TT_KEYS * TC_STR);

    if (w == tiles) {  // pass 1 is done: lse and 1 / l of each row
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        for (int off = 1; off < 4; off <<= 1) l[r] += __shfl_xor_sync(0xffffffffu, l[r], off);
        inv[r] = 1.f / l[r];
      }
      if (tig == 0) {
        if (ra < Sq) lse[((size_t)n * Sq + ra) * H + h] = m[0] + logf(l[0]);
        if (rb < Sq) lse[((size_t)n * Sq + rb) * H + h] = m[1] + logf(l[1]);
      }
    }

    // s[nt]: the 16 x 8 scores of keys j0 + nt * 8 .. + 7
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < TC_HD / 16; ++ks)
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, Ks + (np * 16 + b_row) * TC_STR + ks * 16 + b_col);
        mma_bf16_16816(s[2 * np], qa[ks], b);
        mma_bf16_16816(s[2 * np + 1], qa[ks], b + 2);
      }
    // scale, bias; the causal mask where the tile reaches past the warp's
    // first row (keys past Sk keep their -inf)
    const bool diag = causal && j0 + TT_KEYS - 1 > i0 + r0;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int jj = nt * 8 + tig * 2 + (i & 1), row = i < 2 ? ra : rb;
        float x = s[nt][i] * scale + bs[jj];
        if (diag && j0 + jj > row && j0 + jj < Sk) x = NEG;
        s[nt][i] = x;
      }

    if (!pass2) {
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) mx[i / 2] = fmaxf(mx[i / 2], s[nt][i]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        for (int off = 1; off < 4; off <<= 1)
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], off));
        l[r] *= expf(m[r] - mx[r]);
        m[r] = mx[r];
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) l[i / 2] += expf(s[nt][i] - m[i / 2]);
      continue;
    }

    // pass 2: o += p . v, the C fragments of n-tiles 2kt, 2kt + 1 being the
    // A fragment of the kt-th 16-key step
#pragma unroll
    for (int kt = 0; kt < TT_KEYS / 16; ++kt) {
      float p[8];  // (p[2i], p[2i + 1]) is register a[i] of the fragment
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = expf(s[2 * kt][i] - m[i / 2]) * inv[i / 2];
        p[4 + i] = expf(s[2 * kt + 1][i] - m[i / 2]) * inv[i / 2];
      }
      if constexpr (DROP) {
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          bool keep[4];
          dropout_keep_rows(drop, n, h, ra, rb, j0 + (2 * kt + t) * 8 + tig * 2, tig, keep);
#pragma unroll
          for (int i = 0; i < 4; ++i) p[4 * t + i] = keep[i] ? p[4 * t + i] * drop.scale : 0.f;
        }
      }
      uint32_t a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = pack_bf16(p[2 * i], p[2 * i + 1]);
#pragma unroll
      for (int d2 = 0; d2 < TC_HD / 16; ++d2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, Vs + (kt * 16 + a_row) * TC_STR + d2 * 16 + a_col);
        mma_bf16_16816(o[2 * d2], a, b);
        mma_bf16_16816(o[2 * d2 + 1], a, b + 2);
      }
    }
  }
  cp_async_wait<0>();

  // the output rows go through the warp's own q rows (consumed at item 0),
  // then out as 16-byte stores
  bf16* Os = Qs + r0 * TC_STR;
#pragma unroll
  for (int dt = 0; dt < TC_HD / 8; ++dt) {
    const int d = dt * 8 + tig * 2;
    *reinterpret_cast<uint32_t*>(Os + g * TC_STR + d) = pack_bf16(o[dt][0], o[dt][1]);
    *reinterpret_cast<uint32_t*>(Os + (g + 8) * TC_STR + d) = pack_bf16(o[dt][2], o[dt][3]);
  }
  __syncwarp();
  constexpr int CPR = TC_HD / 8;  // 16-byte chunks a row
#pragma unroll
  for (int c = lane; c < 16 * CPR; c += 32) {
    const int r = c / CPR, d0 = (c % CPR) * 8;
    if (i0 + r0 + r < Sq)
      *reinterpret_cast<uint4*>(out + ((size_t)n * Sq + i0 + r0 + r) * E + (size_t)h * TC_HD +
                                d0) = *reinterpret_cast<const uint4*>(Os + r * TC_STR + d0);
  }
}

template <bool DROP>
inline cudaError_t launch_attention_tiled_tc(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                             const __nv_bfloat16* v, const float* bias,
                                             __nv_bfloat16* out, float* lse, int N, int Sq,
                                             int Sk, int H, float scale, int causal,
                                             Dropout drop, cudaStream_t stream) {
  auto kernel = attention_tiled_tc_kernel<DROP>;
  cudaError_t e = allow_smem(kernel, TT_SMEM_BYTES);
  if (e != cudaSuccess) return e;
  const dim3 grid(N * H, (Sq + TC_ROWS - 1) / TC_ROWS);
  kernel<<<grid, TC_WARPS * 32, TT_SMEM_BYTES, stream>>>(q, k, v, bias, out, lse, Sq, Sk, H,
                                                         scale, causal, drop);
  return cudaGetLastError();
}

}  // namespace ff
