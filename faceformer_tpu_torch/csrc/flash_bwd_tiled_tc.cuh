// K3's key-tiled tensor-core backward: bf16 at hd = 64 past the whole-row
// tensor-core kernels' BT_MAX_SK keys (the flat model's 512-token decoder
// self-attention, a 258-key decoder, anything up to the JAX kernel's ~2,000
// keys). The counterpart of _bwd_kernel (faceformer_tpu/ops/flash.py:140-186)
// with the key side walked in tiles: dq and delta here, dk and dv in
// flash_bwd_dkv_tc_kernel (flash_bwd_tc.cuh) with this kernel's keep bits.
//
// What bounds it here: at the flat decoder's (32, 512) causal call the
// inputs and outputs are 117 MB (0.035 ms at 3.35 TB/s) against 21.5 GFLOP
// of the five products the function needs over the pairs j <= i (0.022 ms
// at the dense bf16 peak), so bytes in principle; in practice the
// instruction throughput of mma.sync (this kernel runs five products a
// tile: s and dp twice, ds . k once), the exponentials (two a score) and
// the Philox draws of dropout (one call per row and 4-key group).
//
// Design, the CUDA-core flash_bwd_dq_tiled_kernel's arithmetic on
// tensor-core fragments (as attention_tiled_tc.cuh is K2's):
//   - a block owns one (sequence, head) and one 64-row query tile, 4 warps
//     of 16 rows; the late (heavy, under the causal mask) tiles launch
//     first. q's and do's A fragments come into registers once by ldmatrix
//     and stay there for both passes;
//   - key tiles of 64 keys with their bias slice come through a cp.async
//     ring (tt_stage of attention_tiled_tc.cuh: rows padded to TC_STR, keys
//     past Sk zero rows with a -inf bias, so their p is exactly 0);
//   - pass 1: s = q . k^T, p = exp(s * scale + bias - lse) with the causal
//     cells at the float32 minimum, dp = do . v^T kept and rescaled with
//     the keep bits of the GLOBAL (i, j) (dropout_keep_rows), and each
//     lane's share of delta = sum p * dp, which its quad sums once at the
//     end: an exact row sum, no atomics;
//   - pass 2 walks the same tiles again (one linear walk of the ring: pass
//     2's first tile arrives under pass 1's last), recomputes s, p and dp,
//     forms ds = p * (dp - delta) * scale rounded to bf16 as the A
//     fragment, and accumulates dq += ds . k in fp32 registers with K's B
//     fragments by ldmatrix.trans. dq leaves through the warp's consumed q
//     rows as 16-byte stores;
//   - p is exp(s - lse), as in the reference: in a row whose every key is
//     masked lse is the float32 minimum and p is 1 at every key;
//   - causal: the key tiles past the query tile's last row are skipped in
//     both passes under causal_skips (flash_bwd_tc.cuh), the rule the dk/dv
//     kernel's walk shares, and only the tiles reaching past a warp's first
//     row are masked element-wise;
//   - dropout: pass 1 draws each tile's bits (one word a lane: n-tile nt,
//     element i at bit 4 nt + i) and writes them to keep_bits (KEEP_TILES);
//     pass 2 reads its own words back, and the dk/dv kernel reads them
//     through its ring, so no bit is drawn twice: Sq * Sk / 8 bytes a
//     (sequence, head) written once and read twice.
#pragma once

#include "attention_tiled_tc.cuh"
#include "flash_bwd_tc.cuh"

namespace ff {

static_assert(TC_HD == BT_HD && TC_STR == BT_STR && TC_ROWS == BT_QT && TT_KEYS == BT_QT,
              "the key-tiled dq kernel's tiles are the dk/dv kernel's");

constexpr int BTT_STAGES = 2;  // depth of the key-tile ring
constexpr size_t BTT_DQ_SMEM_BYTES =
    2 * tc_q_bytes<__nv_bfloat16>() + BTT_STAGES * TT_STAGE_BYTES;

// Grid (N * H, ceil(Sq / TC_ROWS)), TC_WARPS warps; q, k, v, dout, dq bf16
// (N, S, H, 64), bias (N, Sk), lse and delta (N, Sq, H) fp32; keep_bits
// (DROP) N * H * ceil(Sq / 16) * ceil(Sk / 64) * BT_KEEP_TILE words.
template <bool DROP>
__global__ void __launch_bounds__(TC_WARPS * 32)
flash_bwd_dq_tiled_tc_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
                             const float* __restrict__ lse, const __nv_bfloat16* __restrict__ dout,
                             __nv_bfloat16* __restrict__ dq, float* __restrict__ delta,
                             uint32_t* __restrict__ keep_bits, int Sq, int Sk, int H, float scale,
                             int causal, Dropout drop) {
  using bf16 = __nv_bfloat16;
  constexpr int NT = TT_KEYS / 8;  // 8-key n-tiles of a key tile
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ds = Qs + TC_ROWS * TC_STR;
  unsigned char* ring = smem + 2 * tc_q_bytes<bf16>();

  const int n = blockIdx.x / H, h = blockIdx.x % H;
  const int i0 = (gridDim.y - 1 - blockIdx.y) * TC_ROWS;  // late (heavy) tiles first
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int lr = lane & 7, lm = lane >> 3;
  const int a_row = lr + (lm & 1) * 8, a_col = (lm >> 1) * 8;  // ldmatrix.trans of K
  const int b_row = lr + (lm >> 1) * 8, b_col = (lm & 1) * 8;  // ldmatrix of K and V
  const int r0 = warp * 16, ra = i0 + r0 + g, rb = ra + 8;     // the warp's and lane's rows
  const bool rows = i0 + r0 < Sq;  // the warp holds rows of the call
  const size_t E = (size_t)H * TC_HD;

  const int ktiles = (Sk + TT_KEYS - 1) / TT_KEYS;
  const int tiles = causal_skips(causal, bias, n, Sk)
                        ? (min(Sk, i0 + TC_ROWS) + TT_KEYS - 1) / TT_KEYS
                        : ktiles;
  const int items = 2 * tiles;  // pass 1's tiles, then pass 2's
  auto fetch = [&](int w) {
    tt_stage(ring + (w % BTT_STAGES) * TT_STAGE_BYTES, k, v, bias, n, h, H, Sk,
             (w < tiles ? w : w - tiles) * TT_KEYS, true);
  };
  tc_stage_q(Qs, q, n, h, H, Sq, i0);
  tc_stage_q(Ds, dout, n, h, H, Sq, i0);
#pragma unroll
  for (int w = 0; w < BTT_STAGES - 1; ++w) {
    if (w < items) fetch(w);
    cp_async_commit();
  }

  const float la = ra < Sq ? lse[((size_t)n * Sq + ra) * H + h] : 0.f;
  const float lb = rb < Sq ? lse[((size_t)n * Sq + rb) * H + h] : 0.f;
  // the lane's keep-bit word of key tile t is bits[t * BT_KEEP_TILE]
  uint32_t* bits = keep_bits + (((size_t)blockIdx.x * ((Sq + 15) / 16) + (i0 + r0) / 16) *
                                ktiles) * BT_KEEP_TILE + lane;
  uint32_t qa[TC_HD / 16][4], da[TC_HD / 16][4];
  float dl[2] = {0.f, 0.f};
  float o[TC_HD / 8][4];
#pragma unroll
  for (int dt = 0; dt < TC_HD / 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;

  for (int w = 0; w < items; ++w) {
    cp_async_wait<BTT_STAGES - 2>();
    __syncthreads();  // item w has landed everywhere; stage (w - 1) is free
    if (w + BTT_STAGES - 1 < items) fetch(w + BTT_STAGES - 1);
    cp_async_commit();
    if (!rows) continue;  // warp-uniform; no barrier below
    if (w == 0) {
#pragma unroll
      for (int ks = 0; ks < TC_HD / 16; ++ks) {
        tc_a_fragment(Qs + r0 * TC_STR, ks * 16, lane, 1.f, qa[ks]);
        tc_a_fragment(Ds + r0 * TC_STR, ks * 16, lane, 1.f, da[ks]);
      }
    }
    if (w == tiles) {  // pass 1 is done: delta of each row
#pragma unroll
      for (int r = 0; r < 2; ++r)
        for (int off = 1; off < 4; off <<= 1) dl[r] += __shfl_xor_sync(0xffffffffu, dl[r], off);
      if (tig == 0) {
        if (ra < Sq) delta[((size_t)n * Sq + ra) * H + h] = dl[0];
        if (rb < Sq) delta[((size_t)n * Sq + rb) * H + h] = dl[1];
      }
    }
    const bool pass2 = w >= tiles;
    const int t = pass2 ? w - tiles : w, j0 = t * TT_KEYS;
    const unsigned char* st = ring + (w % BTT_STAGES) * TT_STAGE_BYTES;
    const bf16* Ks = reinterpret_cast<const bf16*>(st);
    const bf16* Vs = Ks + TT_KEYS * TC_STR;
    const float* bs = reinterpret_cast<const float*>(Vs + TT_KEYS * TC_STR);

    // s[nt], then p: the 16 x 8 tile of keys j0 + nt * 8 .. + 7
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = dp[nt][i] = 0.f;
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
    // first row (keys past Sk keep their -inf), then p = exp(x - lse)
    const bool diag = causal && j0 + TT_KEYS - 1 > i0 + r0;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int jj = nt * 8 + tig * 2 + (i & 1), row = i < 2 ? ra : rb;
        float x = s[nt][i] * scale + bs[jj];
        if (diag && j0 + jj > row && j0 + jj < Sk) x = NEG;
        s[nt][i] = expf(x - (i < 2 ? la : lb));
      }
    // dp = do . v^T, kept and rescaled
#pragma unroll
    for (int ks = 0; ks < TC_HD / 16; ++ks)
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, Vs + (np * 16 + b_row) * TC_STR + ks * 16 + b_col);
        mma_bf16_16816(dp[2 * np], da[ks], b);
        mma_bf16_16816(dp[2 * np + 1], da[ks], b + 2);
      }
    if constexpr (DROP) {
      uint32_t word = 0u;
      if (!pass2) {
#pragma unroll 2
        for (int nt = 0; nt < NT; ++nt) {
          bool keep[4];
          dropout_keep_rows(drop, n, h, ra, rb, j0 + nt * 8 + tig * 2, tig, keep);
#pragma unroll
          for (int i = 0; i < 4; ++i) word |= (uint32_t)keep[i] << (nt * 4 + i);
        }
        bits[t * BT_KEEP_TILE] = word;
      } else {
        word = bits[t * BT_KEEP_TILE];  // this lane's own store of pass 1
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          dp[nt][i] = (word >> (nt * 4 + i)) & 1u ? dp[nt][i] * drop.scale : 0.f;
    }

    if (!pass2) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) dl[i / 2] += s[nt][i] * dp[nt][i];
      continue;
    }

    // pass 2: dq += ds . k, the ds tiles 2kt, 2kt + 1 being the A fragment
    // of the kt-th 16-key step; k's B fragments by ldmatrix.trans
#pragma unroll
    for (int kt = 0; kt < TT_KEYS / 16; ++kt) {
      uint32_t a[4];
#pragma unroll
      for (int t2 = 0; t2 < 2; ++t2) {
        float ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          ds[i] = s[2 * kt + t2][i] * (dp[2 * kt + t2][i] - dl[i / 2]) * scale;
        a[2 * t2] = pack_bf16(ds[0], ds[1]);
        a[2 * t2 + 1] = pack_bf16(ds[2], ds[3]);
      }
#pragma unroll
      for (int d2 = 0; d2 < TC_HD / 16; ++d2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, Ks + (kt * 16 + a_row) * TC_STR + d2 * 16 + a_col);
        mma_bf16_16816(o[2 * d2], a, b);
        mma_bf16_16816(o[2 * d2 + 1], a, b + 2);
      }
    }
  }
  cp_async_wait<0>();
  if (!rows) return;

  // dq goes through the warp's own q rows (consumed at item 0), then out
  // as 16-byte stores
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
      *reinterpret_cast<uint4*>(dq + ((size_t)n * Sq + i0 + r0 + r) * E + (size_t)h * TC_HD +
                                d0) = *reinterpret_cast<const uint4*>(Os + r * TC_STR + d0);
  }
}

inline size_t bwd_tiled_tc_smem_bytes() {
  return BTT_DQ_SMEM_BYTES > bwd_dkv_tc_smem_bytes(true) ? BTT_DQ_SMEM_BYTES
                                                         : bwd_dkv_tc_smem_bytes(true);
}

// Bytes of keep bits the pair passes on with dropout (KEEP_TILES).
inline size_t bwd_tiled_tc_keep_bytes(int N, int Sq, int Sk, int H) {
  return (size_t)N * H * ((Sq + 15) / 16) * ((Sk + TT_KEYS - 1) / TT_KEYS) * BT_KEEP_TILE *
         sizeof(uint32_t);
}

// dq and delta, then dk and dv: blocks of 4 warps, so each dk/dv block's
// keys are one 64-key tile of the dq kernel and its walk reads only the
// keep bits that kernel drew.
template <bool DROP>
inline cudaError_t launch_bwd_tiled_tc_as(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                          const __nv_bfloat16* v, const float* bias,
                                          const float* lse, const __nv_bfloat16* dout,
                                          __nv_bfloat16* dq, __nv_bfloat16* dk,
                                          __nv_bfloat16* dv, float* delta, uint32_t* keep_bits,
                                          int N, int Sq, int Sk, int H, float scale, int causal,
                                          Dropout drop, cudaStream_t stream) {
  auto dq_kernel = flash_bwd_dq_tiled_tc_kernel<DROP>;
  cudaError_t e = allow_smem(dq_kernel, BTT_DQ_SMEM_BYTES);
  if (e != cudaSuccess) return e;
  dq_kernel<<<dim3(N * H, (Sq + TC_ROWS - 1) / TC_ROWS), TC_WARPS * 32, BTT_DQ_SMEM_BYTES,
              stream>>>(q, k, v, bias, lse, dout, dq, delta, keep_bits, Sq, Sk, H, scale, causal,
                        drop);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  auto kv_kernel = flash_bwd_dkv_tc_kernel<DROP, true>;
  e = allow_smem(kv_kernel, bwd_dkv_tc_smem_bytes(true));
  if (e != cudaSuccess) return e;
  kv_kernel<<<dim3(N * H, (Sk + TT_KEYS - 1) / TT_KEYS), BT_KV_MAX_WARPS * 32,
              bwd_dkv_tc_smem_bytes(true), stream>>>(q, k, v, bias, lse, delta, dout, keep_bits,
                                                     dk, dv, Sq, Sk, H, scale, causal, drop);
  return cudaGetLastError();
}

inline cudaError_t launch_bwd_tiled_tc(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                       const __nv_bfloat16* v, const float* bias,
                                       const float* lse, const __nv_bfloat16* dout,
                                       __nv_bfloat16* dq, __nv_bfloat16* dk, __nv_bfloat16* dv,
                                       float* delta, uint32_t* keep_bits, int N, int Sq, int Sk,
                                       int H, float scale, int causal, Dropout drop,
                                       cudaStream_t stream) {
  return drop.on() ? launch_bwd_tiled_tc_as<true>(q, k, v, bias, lse, dout, dq, dk, dv, delta,
                                                  keep_bits, N, Sq, Sk, H, scale, causal, drop,
                                                  stream)
                   : launch_bwd_tiled_tc_as<false>(q, k, v, bias, lse, dout, dq, dk, dv, delta,
                                                   keep_bits, N, Sq, Sk, H, scale, causal, drop,
                                                   stream);
}

}  // namespace ff
