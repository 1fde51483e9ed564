// Tensor-core kernels of the flash backward (flash_bwd.cu says what the
// backward computes and why it is two kernels): bf16, hd = 64. The dq
// kernel here takes Sk <= 256 (the whole key side in shared memory); the
// dk/dv kernel takes any Sk, after this dq kernel or after the key-tiled
// one of flash_bwd_tiled_tc.cuh. Products run on mma.sync m16n8k16 with
// fp32 accumulation; fragment layouts are those of common.cuh.
//
// Data path. Every bf16 tile sits in shared memory row-major, as it lies
// in device memory, with rows padded to 144 bytes so that the eight rows of
// one ldmatrix fall on distinct banks. A fragments and the B fragments of
// products against a row-major operand's rows come from ldmatrix; the B
// fragments that need the transpose (K in ds . k, q and do in ds^T . q and
// p_used^T . do) come from ldmatrix.trans. Nothing is transposed by scalar
// stores. The 64-row query tiles of q and do, with their fp32 per-row
// values (lse; delta for dk/dv), come through a ring of shared-memory
// stages filled by cp.async (16 B a thread; 4 B for the fp32 rows; rows
// past Sq zero-filled): the copy of the next tile runs while the current
// tile's products run, and one __syncthreads per tile hands a stage back.
//
// Dropout. The dq kernel draws every keep bit of the call (one Philox call
// per four elements, common.cuh) and writes them out as its lanes hold
// them. This file's dq kernel (KEEP_ROWS): per (sequence, head) and group
// of 16 query rows, each lane's four words of bits (tile nt, element i of
// the mma C fragment at bit 4 nt + i), 512 bytes a group: N * H *
// ceil(Sq / 16) * 512 bytes, 70.8 MB at the cross-attention shape of N =
// 32. The key-tiled dq kernel (KEEP_TILES): per group of 16 rows and
// 64-key tile, one word a lane, 128 bytes: N * H * ceil(Sq / 16) *
// ceil(Sk / 64) * 128 bytes, Sq * Sk / 8 a (sequence, head). The dk/dv
// kernel reads them through its ring with the q and do tiles and draws
// nothing.
#pragma once

#include "common.cuh"

namespace ff {

constexpr int BT_HD = 64;
constexpr int BT_MAX_SK = 256;
constexpr int BT_QT = 64;                // query rows of one staged tile
constexpr int BT_STR = BT_HD + 8;        // padded row of a 64-wide bf16 tile (144 B)
constexpr int BT_DQ_WARPS = BT_QT / 16;  // dq: a warp owns 16 rows of the tile
constexpr int BT_DQ_STAGES = 2;
constexpr int BT_KV_MAX_WARPS = 4;       // dk/dv: a warp owns 16 keys
constexpr int BT_KV_STAGES = 3;
constexpr int BT_KEEP_GROUP = 32 * 4;    // KEEP_ROWS: keep-bit words per 16 query rows
constexpr int BT_KEEP_TILE = 32;         // KEEP_TILES: words per 16 query rows and 64-key tile

// The keep-bit layout a ring stage copies (the file's header describes both)
enum BwdKeep { KEEP_NONE = 0, KEEP_ROWS = 1, KEEP_TILES = 2 };
__host__ __device__ constexpr int bt_keep_words(int keep) {
  return keep == KEEP_ROWS ? BT_KEEP_GROUP : keep == KEEP_TILES ? BT_KEEP_TILE : 0;
}

// One ring stage: the q and do tiles, then NF fp32 values per row, then
// (dk/dv) the rows' keep bits in layout KEEP.
__host__ __device__ constexpr size_t bwd_stage_bytes(int nf, int keep) {
  return (size_t)2 * BT_QT * BT_STR * 2 + (size_t)nf * BT_QT * 4 +
         (size_t)BT_QT / 16 * bt_keep_words(keep) * 4;
}

template <int KT> constexpr size_t bwd_dq_tc_smem_bytes() {
  return (size_t)2 * KT * 16 * BT_STR * 2 + (size_t)KT * 16 * 4 +
         BT_DQ_STAGES * bwd_stage_bytes(1, KEEP_NONE);
}
// the dk/dv kernel's ring, with room for the keep bits of the layout its
// dq kernel writes
constexpr size_t bwd_dkv_tc_smem_bytes(bool tiled) {
  return BT_KV_STAGES * bwd_stage_bytes(2, tiled ? KEEP_TILES : KEEP_ROWS);
}

// Under the causal mask row i sees keys 0 .. i. Where key 0 of sequence n
// is live (its bias above the float32 minimum) every row sees a live key,
// its lse is finite and p = exp(s - lse) is exactly 0 above the diagonal,
// so a kernel may skip the key tiles past its query rows (dq) or the query
// rows before its keys (dk/dv). A row whose keys 0 .. i are all masked has
// its lse at the float32 minimum and p = 1 at EVERY key, above the
// diagonal too, as in the reference (faceformer_tpu/ops/flash.py:153): in
// a sequence whose key 0 is masked every kernel walks every tile. The dq
// and dk/dv kernels of one call take the same rule, so the dk/dv kernel
// reads only keep bits that its dq kernel drew.
__device__ __forceinline__ bool causal_skips(int causal, const float* bias, int n, int Sk) {
  return causal && bias[(size_t)n * Sk] > NEG;
}

// Start the copy of query tile t (rows t * BT_QT ..) of q and do, of NF
// per-row fp32 values (f0 = lse, f1 = delta) and of the rows' keep bits in
// layout KEEP (KEEP_TILES: those of key tile kt of ktiles) into one ring
// stage. Every thread of the block calls it; it commits nothing.
template <int NF, int KEEP>
__device__ __forceinline__ void bwd_stage_tile(unsigned char* stage, const __nv_bfloat16* q,
                                               const __nv_bfloat16* dout, const float* f0,
                                               const float* f1, const uint32_t* bits, int n,
                                               int h, int H, int Sq, int t, int kt = 0,
                                               int ktiles = 0) {
  auto Qs = reinterpret_cast<__nv_bfloat16*>(stage);
  auto Ds = Qs + BT_QT * BT_STR;
  auto Fs = reinterpret_cast<float*>(Ds + BT_QT * BT_STR);
  const size_t E = (size_t)H * BT_HD;
  const int i0 = t * BT_QT;
  for (int c = threadIdx.x; c < BT_QT * (BT_HD / 8); c += blockDim.x) {
    const int r = c / (BT_HD / 8), d0 = (c % (BT_HD / 8)) * 8;
    const bool ok = i0 + r < Sq;
    const size_t gi = ok ? ((size_t)n * Sq + i0 + r) * E + (size_t)h * BT_HD + d0 : 0;
    cp_async16(Qs + r * BT_STR + d0, q + gi, ok);
    cp_async16(Ds + r * BT_STR + d0, dout + gi, ok);
  }
  for (int c = threadIdx.x; c < NF * BT_QT; c += blockDim.x) {
    const int r = c % BT_QT;
    const bool ok = i0 + r < Sq;
    const size_t gi = ok ? ((size_t)n * Sq + i0 + r) * H + h : 0;
    cp_async4(Fs + c, (c < BT_QT ? f0 : f1) + gi, ok);
  }
  if constexpr (KEEP != KEEP_NONE) {
    constexpr int W = bt_keep_words(KEEP);
    auto Ws = reinterpret_cast<uint32_t*>(Fs + NF * BT_QT);
    const int groups = (Sq + 15) / 16, g0 = t * (BT_QT / 16);
    for (int c = threadIdx.x; c < BT_QT / 16 * W / 4; c += blockDim.x) {
      const int grp = c / (W / 4), w0 = (c % (W / 4)) * 4;
      const bool ok = g0 + grp < groups;
      const size_t row = ((size_t)n * H + h) * groups + g0 + grp;
      const size_t gi = ok ? (KEEP == KEEP_ROWS ? row : row * ktiles + kt) * W + w0 : 0;
      cp_async16(Ws + grp * W + w0, bits + gi, ok);
    }
  }
}

// dq and delta. Grid (N * H, splits), 4 warps of 16 query rows. A block
// copies K, V and the bias row of its (sequence, head) into shared memory
// once, padded to KT * 16 keys with zeros (keys past Sk get bias -inf, so
// p = 0 there), then walks the query tiles y, y + splits, ... (y =
// blockIdx.y) through a 2-stage ring. A warp keeps the whole p rows of its
// 16 queries in registers (as the forward keeps its scores). dp = do . v^T
// is computed tile by tile twice: once for delta = sum p * dp, once more
// for ds, which goes straight into dq = ds . k. The keep bits are drawn
// first, into a register bit mask that both sweeps read and that goes out
// to keep_bits for the dk/dv kernel. Four products per tile.
template <int KT, bool DROP>
__global__ void __launch_bounds__(BT_DQ_WARPS * 32)
flash_bwd_dq_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
                       const float* __restrict__ lse, const __nv_bfloat16* __restrict__ dout,
                       __nv_bfloat16* __restrict__ dq, float* __restrict__ delta,
                       uint32_t* __restrict__ keep_bits, int Sq, int Sk, int H, float scale,
                       int causal, Dropout drop) {
  using bf16 = __nv_bfloat16;
  constexpr int SKP = KT * 16, NT = 2 * KT, S = BT_DQ_STAGES;
  constexpr size_t STAGE = bwd_stage_bytes(1, KEEP_NONE);
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);  // [SKP][BT_STR]
  bf16* Vs = Ks + SKP * BT_STR;               // [SKP][BT_STR]
  float* bs = reinterpret_cast<float*>(Vs + SKP * BT_STR);
  unsigned char* ring = reinterpret_cast<unsigned char*>(bs + SKP);

  const int n = blockIdx.x / H, h = blockIdx.x % H, splits = gridDim.y;
  const size_t E = (size_t)H * BT_HD;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int tiles = (Sq + BT_QT - 1) / BT_QT;
  // ldmatrix row/column offsets of this lane: A fragments and transposed B
  // (a_), B fragments of two 8-wide n-tiles from an [n][k] tile (b_)
  const int lr = lane & 7, lm = lane >> 3;
  const int a_row = lr + (lm & 1) * 8, a_col = (lm >> 1) * 8;
  const int b_row = lr + (lm >> 1) * 8, b_col = (lm & 1) * 8;

  for (int c = tid; c < SKP * (BT_HD / 8); c += blockDim.x) {
    const int j = c / (BT_HD / 8), d0 = (c % (BT_HD / 8)) * 8;
    const bool ok = j < Sk;
    const size_t gi = ok ? ((size_t)n * Sk + j) * E + (size_t)h * BT_HD + d0 : 0;
    cp_async16(Ks + j * BT_STR + d0, k + gi, ok);
    cp_async16(Vs + j * BT_STR + d0, v + gi, ok);
  }
  for (int j = tid; j < SKP; j += blockDim.x)
    bs[j] = j < Sk ? bias[(size_t)n * Sk + j] : -INFINITY;
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    const int t = blockIdx.y + s * splits;
    if (t < tiles)
      bwd_stage_tile<1, KEEP_NONE>(ring + s * STAGE, q, dout, lse, nullptr, nullptr, n, h, H, Sq,
                                   t);
    cp_async_commit();
  }

  for (int it = 0, t = blockIdx.y; t < tiles; ++it, t += splits) {
    cp_async_wait<S - 2>();
    __syncthreads();  // tile t has landed everywhere; stage (it - 1) % S is free
    const int tn = t + (S - 1) * splits;
    if (tn < tiles)
      bwd_stage_tile<1, KEEP_NONE>(ring + ((it + S - 1) % S) * STAGE, q, dout, lse, nullptr,
                                   nullptr, n, h, H, Sq, tn);
    cp_async_commit();

    const bf16* Qs = reinterpret_cast<const bf16*>(ring + (it % S) * STAGE);
    const bf16* Ds = Qs + BT_QT * BT_STR;
    const float* Ls = reinterpret_cast<const float*>(Ds + BT_QT * BT_STR);
    const int r0 = warp * 16;  // the warp's rows within the tile
    const int ra = t * BT_QT + r0 + g, rb = ra + 8;
    if (ra - g >= Sq) continue;
    const bool va = ra < Sq, vb = rb < Sq;

    // the keep bits of the warp's rows (tile nt, element i at bit 4 nt + i),
    // drawn before s is live, two Philox calls at a time
    uint32_t kept[(NT * 4 + 31) / 32];
#pragma unroll
    for (int w = 0; w < (NT * 4 + 31) / 32; ++w) kept[w] = 0u;
    if constexpr (DROP) {
#pragma unroll
      for (int w = 0; w < (NT * 4 + 31) / 32; ++w) {
        uint32_t word = 0u;
#pragma unroll 2
        for (int u = 0; u < 8 && w * 8 + u < NT; ++u) {
          bool keep[4];
          dropout_keep_rows(drop, n, h, ra, rb, (w * 8 + u) * 8 + tig * 2, tig, keep);
#pragma unroll
          for (int i = 0; i < 4; ++i) word |= (uint32_t)keep[i] << (u * 4 + i);
        }
        kept[w] = word;
      }
    }

    // s = q . k^T, then p = exp(s * scale + bias - lse), kept in s
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < BT_HD / 16; ++ks) {
      uint32_t a[4];
      ldmatrix_x4(a, Qs + (r0 + a_row) * BT_STR + ks * 16 + a_col);
#pragma unroll
      for (int np = 0; np < KT; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, Ks + (np * 16 + b_row) * BT_STR + ks * 16 + b_col);
        mma_bf16_16816(s[2 * np], a, b);
        mma_bf16_16816(s[2 * np + 1], a, b + 2);
      }
    }
    const float la = Ls[r0 + g], lb = Ls[r0 + g + 8];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = nt * 8 + tig * 2 + (i & 1), row = i < 2 ? ra : rb;
        float x = s[nt][i] * scale + bs[j];
        if (causal && j > row && j < Sk) x = NEG;
        s[nt][i] = expf(x - (i < 2 ? la : lb));
      }

    uint32_t doa[BT_HD / 16][4];
#pragma unroll
    for (int ks = 0; ks < BT_HD / 16; ++ks)
      ldmatrix_x4(doa[ks], Ds + (r0 + a_row) * BT_STR + ks * 16 + a_col);

    // dp tiles 2np, 2np + 1 (16 rows x 16 keys) = do . v^T, masked and rescaled
    auto dp_pair = [&](int np, float (*dp)[4]) {
#pragma unroll
      for (int t2 = 0; t2 < 2; ++t2) dp[t2][0] = dp[t2][1] = dp[t2][2] = dp[t2][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < BT_HD / 16; ++ks) {
        uint32_t b[4];
        ldmatrix_x4(b, Vs + (np * 16 + b_row) * BT_STR + ks * 16 + b_col);
        mma_bf16_16816(dp[0], doa[ks], b);
        mma_bf16_16816(dp[1], doa[ks], b + 2);
      }
      if constexpr (DROP) {
#pragma unroll
        for (int t2 = 0; t2 < 2; ++t2) {
          const int bit = (2 * np + t2) * 4;  // a tile's four bits never straddle a word
#pragma unroll
          for (int i = 0; i < 4; ++i)
            dp[t2][i] = (kept[bit / 32] >> (bit % 32 + i)) & 1u ? dp[t2][i] * drop.scale : 0.f;
        }
      }
    };

    float dl[2] = {0.f, 0.f};
#pragma unroll
    for (int np = 0; np < KT; ++np) {
      float dp[2][4];
      dp_pair(np, dp);
#pragma unroll
      for (int t2 = 0; t2 < 2; ++t2)
#pragma unroll
        for (int i = 0; i < 4; ++i) dl[i / 2] += s[2 * np + t2][i] * dp[t2][i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
      for (int off = 1; off < 4; off <<= 1) dl[r] += __shfl_xor_sync(0xffffffffu, dl[r], off);
    if (tig == 0) {
      if (va) delta[((size_t)n * Sq + ra) * H + h] = dl[0];
      if (vb) delta[((size_t)n * Sq + rb) * H + h] = dl[1];
    }
    // dq = ds . k: the ds tiles 2kt, 2kt+1 are the A fragment of 16-key
    // step kt; k's B fragments come from row-major K by ldmatrix.trans
    float o[BT_HD / 8][4];
#pragma unroll
    for (int dt = 0; dt < BT_HD / 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      float dp[2][4];
      dp_pair(kt, dp);
      uint32_t a[4];
#pragma unroll
      for (int t2 = 0; t2 < 2; ++t2) {
        float ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) ds[i] = s[2 * kt + t2][i] * (dp[t2][i] - dl[i / 2]) * scale;
        a[2 * t2] = pack_bf16(ds[0], ds[1]);
        a[2 * t2 + 1] = pack_bf16(ds[2], ds[3]);
      }
#pragma unroll
      for (int d2 = 0; d2 < BT_HD / 16; ++d2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, Ks + (kt * 16 + a_row) * BT_STR + d2 * 16 + a_col);
        mma_bf16_16816(o[2 * d2], a, b);
        mma_bf16_16816(o[2 * d2 + 1], a, b + 2);
      }
    }
    const size_t offa = ((size_t)n * Sq + ra) * E + (size_t)h * BT_HD;
    const size_t offb = ((size_t)n * Sq + rb) * E + (size_t)h * BT_HD;
#pragma unroll
    for (int dt = 0; dt < BT_HD / 8; ++dt) {
      const int d = dt * 8 + tig * 2;
      if (va) *reinterpret_cast<uint32_t*>(dq + offa + d) = pack_bf16(o[dt][0], o[dt][1]);
      if (vb) *reinterpret_cast<uint32_t*>(dq + offb + d) = pack_bf16(o[dt][2], o[dt][3]);
    }
    if constexpr (DROP) {
      static_assert((NT * 4 + 31) / 32 <= 4, "a lane's keep bits fill at most four words");
      uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int i = 0; i < (NT * 4 + 31) / 32; ++i) w[i] = kept[i];
      const size_t grp = (size_t)blockIdx.x * ((Sq + 15) / 16) + (t * BT_QT + r0) / 16;
      *reinterpret_cast<uint4*>(keep_bits + grp * BT_KEEP_GROUP + lane * 4) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
  cp_async_wait<0>();
}

// dk and dv. Grid (N * H, key blocks), one warp per 16 keys: the key side
// is cut into ceil(Sk / 16) warps spread evenly over as few blocks of at
// most 4 warps as hold them (Sk = 220: 4 blocks of 4 warps, the last with
// 2 idle), so products are padded to 16 keys only. A warp keeps its keys'
// K and V rows in registers as A fragments and its dK, dV in fp32
// registers for the whole walk. The block walks every query tile (from the
// tile of its first key when causal_skips) through a 3-stage ring; each
// staged tile (with its keep bits) feeds all the block's keys. TILED: after
// the key-tiled dq kernel (flash_bwd_tiled_tc.cuh), whose keep bits it
// reads (KEEP_TILES); the launch then gives every block 4 warps, so a
// block's keys are one 64-key tile of that kernel. Per 16 queries a
// warp computes s^T = k . q^T and dp^T = v . do^T (16 keys x 16 queries),
// p_used^T and ds^T, then dk += ds^T . q and dv += p_used^T . do. Four
// products per tile. The walk order is fixed and nothing is summed across
// blocks, so dk and dv are bitwise repeatable.
template <bool DROP, bool TILED>
__global__ void __launch_bounds__(BT_KV_MAX_WARPS * 32)
flash_bwd_dkv_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        const __nv_bfloat16* __restrict__ dout,
                        const uint32_t* __restrict__ keep_bits, __nv_bfloat16* __restrict__ dk,
                        __nv_bfloat16* __restrict__ dv, int Sq, int Sk, int H, float scale,
                        int causal, Dropout drop) {
  using bf16 = __nv_bfloat16;
  constexpr int S = BT_KV_STAGES;
  constexpr int LAYOUT = TILED ? KEEP_TILES : KEEP_ROWS;
  constexpr int KEEP = DROP ? LAYOUT : KEEP_NONE;
  constexpr size_t STAGE = bwd_stage_bytes(2, LAYOUT);
  extern __shared__ __align__(16) unsigned char smem[];

  const int n = blockIdx.x / H, h = blockIdx.x % H;
  const int j0 = blockIdx.y * (blockDim.x / 32) * 16;
  const int kt = TILED ? j0 / BT_QT : 0, ktiles = TILED ? (Sk + BT_QT - 1) / BT_QT : 0;
  const size_t E = (size_t)H * BT_HD;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int lr = lane & 7, lm = lane >> 3;
  const int a_row = lr + (lm & 1) * 8, a_col = (lm >> 1) * 8;
  const int b_row = lr + (lm >> 1) * 8, b_col = (lm & 1) * 8;

  const bool active = j0 + warp * 16 < Sk;  // the last block may hold warps past Sk
  const int ka = j0 + warp * 16 + g, kb = ka + 8;
  // the dq lanes that drew ka's and kb's bits: tile nt = ka / 8 (kb's is
  // nt + 1, in the same word) of rows 2 tig, 2 tig + 1 (+ 8) of a group,
  // pair of keys g / 2, element g % 2 (+ 2 for the rows + 8); KEEP_ROWS:
  // word ka / 64 of the lane's four, KEEP_TILES: the lane's one word of
  // key tile kt
  const int kword = TILED ? 0 : ka / 64, kbit = ka / 8 % 8 * 4 + g % 2;
  const int klane = 8 * tig + g / 2, kstride = TILED ? 1 : 4;
  const bool va = ka < Sk, vb = kb < Sk;
  const size_t offa = ((size_t)n * Sk + ka) * E + (size_t)h * BT_HD;
  const size_t offb = ((size_t)n * Sk + kb) * E + (size_t)h * BT_HD;
  uint32_t kf[BT_HD / 16][4], vf[BT_HD / 16][4];
#pragma unroll
  for (int ks = 0; ks < BT_HD / 16; ++ks) {
    load_a_fragment(k + offa, k + offb, va, vb, ks * 16 + tig * 2, 1.f, kf[ks]);
    load_a_fragment(v + offa, v + offb, va, vb, ks * 16 + tig * 2, 1.f, vf[ks]);
  }
  // keys past Sk: bias -inf, so p = 0
  const float ba = va ? bias[(size_t)n * Sk + ka] : -INFINITY;
  const float bb = vb ? bias[(size_t)n * Sk + kb] : -INFINITY;

  float ok[BT_HD / 8][4], ov[BT_HD / 8][4];
#pragma unroll
  for (int dt = 0; dt < BT_HD / 8; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) ok[dt][i] = ov[dt][i] = 0.f;

  // under the causal mask the rows before the block's first key see none
  // of its keys, their p exactly 0, unless a row sees no live key (the
  // bias is read only where there are tiles to skip, off the critical path
  // of short blocks such as the parallel decoder's 40-key ones)
  const int tiles = (Sq + BT_QT - 1) / BT_QT;
  const int t0 = j0 >= BT_QT && causal_skips(causal, bias, n, Sk) ? j0 / BT_QT : 0;
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (t0 + s < tiles)
      bwd_stage_tile<2, KEEP>(smem + s * STAGE, q, dout, lse, delta, keep_bits, n, h, H, Sq,
                              t0 + s, kt, ktiles);
    cp_async_commit();
  }

  for (int it = 0, t = t0; t < tiles; ++it, ++t) {
    cp_async_wait<S - 2>();
    __syncthreads();  // tile t has landed everywhere; stage (it - 1) % S is free
    if (t + S - 1 < tiles)
      bwd_stage_tile<2, KEEP>(smem + ((it + S - 1) % S) * STAGE, q, dout, lse, delta, keep_bits,
                              n, h, H, Sq, t + S - 1, kt, ktiles);
    cp_async_commit();
    if (!active) continue;

    const bf16* Qs = reinterpret_cast<const bf16*>(smem + (it % S) * STAGE);
    const bf16* Ds = Qs + BT_QT * BT_STR;
    const float* Ls = reinterpret_cast<const float*>(Ds + BT_QT * BT_STR);
    const float* Dls = Ls + BT_QT;
    const uint32_t* Ws = reinterpret_cast<const uint32_t*>(Dls + BT_QT);
    const int i0 = t * BT_QT;
#pragma unroll
    for (int c = 0; c < BT_QT / 16; ++c) {
      if (i0 + c * 16 >= Sq) break;
      // st = (k . q^T), dpt = (v . do^T): rows = keys, cols = 16 queries
      float st[2][4], dpt[2][4];
#pragma unroll
      for (int t2 = 0; t2 < 2; ++t2)
#pragma unroll
        for (int i = 0; i < 4; ++i) st[t2][i] = dpt[t2][i] = 0.f;
#pragma unroll
      for (int ks = 0; ks < BT_HD / 16; ++ks) {
        uint32_t b[4];
        ldmatrix_x4(b, Qs + (c * 16 + b_row) * BT_STR + ks * 16 + b_col);
        mma_bf16_16816(st[0], kf[ks], b);
        mma_bf16_16816(st[1], kf[ks], b + 2);
        ldmatrix_x4(b, Ds + (c * 16 + b_row) * BT_STR + ks * 16 + b_col);
        mma_bf16_16816(dpt[0], vf[ks], b);
        mma_bf16_16816(dpt[1], vf[ks], b + 2);
      }

      // st <- p_used^T, dpt <- ds^T
#pragma unroll
      for (int t2 = 0; t2 < 2; ++t2) {
        const int ib = c * 16 + t2 * 8 + tig * 2;  // the lane's first query within the tile
        bool keep[4];
        if constexpr (DROP) {
          const uint32_t* wg = Ws + c * bt_keep_words(LAYOUT) + kword;
          const uint32_t w0 = wg[klane * kstride], w1 = wg[(klane + 4) * kstride];  // ib, ib + 1
          const int bit = kbit + 2 * t2;
          keep[0] = (w0 >> bit) & 1u;
          keep[1] = (w1 >> bit) & 1u;
          keep[2] = (w0 >> (bit + 4)) & 1u;
          keep[3] = (w1 >> (bit + 4)) & 1u;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int ii = ib + (i & 1), iq = i0 + ii;
          const int key = i < 2 ? ka : kb;
          float x = st[t2][i] * scale + (i < 2 ? ba : bb);
          if (causal && key > iq && key < Sk) x = NEG;
          float p = iq < Sq ? expf(x - Ls[ii]) : 0.f;
          float dp = dpt[t2][i], pu = p;
          if constexpr (DROP) {
            pu = keep[i] ? p * drop.scale : 0.f;
            dp = keep[i] ? dp * drop.scale : 0.f;
          }
          st[t2][i] = pu;
          dpt[t2][i] = p * (dp - Dls[ii]) * scale;
        }
      }

      // dk += ds^T . q, dv += p_used^T . do: the two 8-query tiles are the
      // A fragment; q's and do's B fragments come by ldmatrix.trans
      const uint32_t as[4] = {pack_bf16(dpt[0][0], dpt[0][1]), pack_bf16(dpt[0][2], dpt[0][3]),
                              pack_bf16(dpt[1][0], dpt[1][1]), pack_bf16(dpt[1][2], dpt[1][3])};
      const uint32_t ap[4] = {pack_bf16(st[0][0], st[0][1]), pack_bf16(st[0][2], st[0][3]),
                              pack_bf16(st[1][0], st[1][1]), pack_bf16(st[1][2], st[1][3])};
#pragma unroll
      for (int d2 = 0; d2 < BT_HD / 16; ++d2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, Qs + (c * 16 + a_row) * BT_STR + d2 * 16 + a_col);
        mma_bf16_16816(ok[2 * d2], as, b);
        mma_bf16_16816(ok[2 * d2 + 1], as, b + 2);
        ldmatrix_x4_trans(b, Ds + (c * 16 + a_row) * BT_STR + d2 * 16 + a_col);
        mma_bf16_16816(ov[2 * d2], ap, b);
        mma_bf16_16816(ov[2 * d2 + 1], ap, b + 2);
      }
    }
  }
  cp_async_wait<0>();
  if (!active) return;

#pragma unroll
  for (int dt = 0; dt < BT_HD / 8; ++dt) {
    const int d = dt * 8 + tig * 2;
    if (va) {
      *reinterpret_cast<uint32_t*>(dk + offa + d) = pack_bf16(ok[dt][0], ok[dt][1]);
      *reinterpret_cast<uint32_t*>(dv + offa + d) = pack_bf16(ov[dt][0], ov[dt][1]);
    }
    if (vb) {
      *reinterpret_cast<uint32_t*>(dk + offb + d) = pack_bf16(ok[dt][2], ok[dt][3]);
      *reinterpret_cast<uint32_t*>(dv + offb + d) = pack_bf16(ov[dt][2], ov[dt][3]);
    }
  }
}

// The dq kernel's query-tile splits: as many blocks as the card holds at
// once (SMs x resident blocks per SM), shared out over the N * H pairs, at
// least 1 and at most one split per tile.
template <typename K>
inline cudaError_t bwd_dq_splits(K kernel, size_t smem, int pairs, int tiles, int* splits) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, BT_DQ_WARPS * 32, smem);
  const int fit = sms * per_sm / pairs;
  *splits = fit < 1 ? 1 : fit > tiles ? tiles : fit;
  return e;
}

template <int KT, bool DROP>
inline cudaError_t launch_bwd_tc_as(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                    const __nv_bfloat16* v, const float* bias, const float* lse,
                                    const __nv_bfloat16* dout, __nv_bfloat16* dq,
                                    __nv_bfloat16* dk, __nv_bfloat16* dv, float* delta,
                                    uint32_t* keep_bits, int N, int Sq, int Sk, int H,
                                    float scale, int causal, Dropout drop, cudaStream_t stream) {
  constexpr size_t smem = bwd_dq_tc_smem_bytes<KT>();
  auto dq_kernel = flash_bwd_dq_tc_kernel<KT, DROP>;
  cudaError_t e = allow_smem(dq_kernel, smem);
  if (e != cudaSuccess) return e;
  const int tiles = (Sq + BT_QT - 1) / BT_QT;
  int splits = 1;
  e = bwd_dq_splits(dq_kernel, smem, N * H, tiles, &splits);
  if (e != cudaSuccess) return e;
  dq_kernel<<<dim3(N * H, splits), BT_DQ_WARPS * 32, smem, stream>>>(
      q, k, v, bias, lse, dout, dq, delta, keep_bits, Sq, Sk, H, scale, causal, drop);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  const int key_warps = (Sk + 15) / 16;
  const int blocks = (key_warps + BT_KV_MAX_WARPS - 1) / BT_KV_MAX_WARPS;
  const int warps = (key_warps + blocks - 1) / blocks;
  auto kv_kernel = flash_bwd_dkv_tc_kernel<DROP, false>;
  e = allow_smem(kv_kernel, bwd_dkv_tc_smem_bytes(false));
  if (e != cudaSuccess) return e;
  kv_kernel<<<dim3(N * H, blocks), warps * 32, bwd_dkv_tc_smem_bytes(false), stream>>>(
      q, k, v, bias, lse, delta, dout, keep_bits, dk, dv, Sq, Sk, H, scale, causal, drop);
  return cudaGetLastError();
}

inline int bwd_tc_key_tiles(int Sk) {
  const int kt = (Sk + 15) / 16;
  return kt <= 3 ? 3 : kt <= 8 ? 8 : kt <= 14 ? 14 : 16;
}

inline size_t bwd_tc_smem_bytes(int Sk) {
  size_t dq;
  switch (bwd_tc_key_tiles(Sk)) {
    case 3: dq = bwd_dq_tc_smem_bytes<3>(); break;
    case 8: dq = bwd_dq_tc_smem_bytes<8>(); break;
    case 14: dq = bwd_dq_tc_smem_bytes<14>(); break;
    default: dq = bwd_dq_tc_smem_bytes<16>();
  }
  return dq > bwd_dkv_tc_smem_bytes(false) ? dq : bwd_dkv_tc_smem_bytes(false);
}

inline cudaError_t launch_bwd_tc(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                 const __nv_bfloat16* v, const float* bias, const float* lse,
                                 const __nv_bfloat16* dout, __nv_bfloat16* dq, __nv_bfloat16* dk,
                                 __nv_bfloat16* dv, float* delta, uint32_t* keep_bits, int N,
                                 int Sq, int Sk, int H, float scale, int causal, Dropout drop,
                                 cudaStream_t stream) {
#define FF_BWD_TC(KT)                                                                        \
  return drop.on() ? launch_bwd_tc_as<KT, true>(q, k, v, bias, lse, dout, dq, dk, dv, delta, \
                                                keep_bits, N, Sq, Sk, H, scale, causal, drop, \
                                                stream)                                      \
                   : launch_bwd_tc_as<KT, false>(q, k, v, bias, lse, dout, dq, dk, dv, delta, \
                                                 keep_bits, N, Sq, Sk, H, scale, causal, drop, \
                                                 stream)
  switch (bwd_tc_key_tiles(Sk)) {
    case 3: FF_BWD_TC(3);
    case 8: FF_BWD_TC(8);
    case 14: FF_BWD_TC(14);
    default: FF_BWD_TC(16);
  }
#undef FF_BWD_TC
}

}  // namespace ff
