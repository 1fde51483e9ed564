// Tensor-core kernels of the flash backward (flash_bwd.cu says what the
// backward computes and why it is two kernels): bf16, hd = 64, Sk <= 256.
// Products run on mma.sync m16n8k16 with fp32 accumulation; fragment
// layouts are those of common.cuh.
#pragma once

#include "common.cuh"

namespace ff {

constexpr int BT_HD = 64;
constexpr int BT_WARPS = 4;
constexpr int BT_ROWS = 16 * BT_WARPS;  // query rows (dq) or keys (dk/dv) per block
constexpr int BT_MAX_SK = 256;
constexpr int BT_STR = BT_HD + 8;       // padded row of a 64-wide bf16 tile

template <int KT> constexpr size_t bwd_dq_tc_smem_bytes() {
  return (size_t)2 * KT * 16 * BT_STR * 2 + (size_t)BT_HD * (KT * 16 + 8) * 2 + KT * 16 * 4;
}

// dq and delta. Grid (N * H, ceil(Sq / 64)), 4 warps of 16 query rows. K and
// V of the (sequence, head) sit in shared memory row-major, K also
// transposed, all padded to KT * 16 keys with zeros; keys past Sk get bias
// -inf, so p = 0 there. A warp keeps the whole p rows of its 16 queries in
// registers (as the forward keeps its scores). dp = do . v^T is computed
// tile by tile twice: once for delta = sum p * dp, once more for ds, which
// goes straight into dq = ds . k. The keep bits of the first sweep are
// kept in a register bit mask for the second.
template <int KT, bool DROP>
__global__ void __launch_bounds__(BT_WARPS * 32)
flash_bwd_dq_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
                       const float* __restrict__ lse, const __nv_bfloat16* __restrict__ dout,
                       __nv_bfloat16* __restrict__ dq, float* __restrict__ delta, int Sq, int Sk,
                       int H, float scale, int causal, Dropout drop) {
  using bf16 = __nv_bfloat16;
  constexpr int SKP = KT * 16, TSTR = SKP + 8, NT = 2 * KT;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);  // [SKP][BT_STR]
  bf16* Vs = Ks + SKP * BT_STR;               // [SKP][BT_STR]
  bf16* Kt = Vs + SKP * BT_STR;               // [BT_HD][TSTR]
  float* bs = reinterpret_cast<float*>(Kt + BT_HD * TSTR);

  const int n = blockIdx.x / H, h = blockIdx.x % H;
  const size_t E = (size_t)H * BT_HD;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tig = lane & 3;

  for (int c = tid; c < SKP * (BT_HD / 8); c += blockDim.x) {
    const int j = c / (BT_HD / 8), d0 = (c % (BT_HD / 8)) * 8;
    uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
    if (j < Sk) {
      const size_t gi = ((size_t)n * Sk + j) * E + (size_t)h * BT_HD + d0;
      kv = *reinterpret_cast<const uint4*>(k + gi);
      vv = *reinterpret_cast<const uint4*>(v + gi);
    }
    *reinterpret_cast<uint4*>(Ks + j * BT_STR + d0) = kv;
    *reinterpret_cast<uint4*>(Vs + j * BT_STR + d0) = vv;
    const bf16* ke = reinterpret_cast<const bf16*>(&kv);
#pragma unroll
    for (int i = 0; i < 8; ++i) Kt[(d0 + i) * TSTR + j] = ke[i];
  }
  for (int j = tid; j < SKP; j += blockDim.x)
    bs[j] = j < Sk ? bias[(size_t)n * Sk + j] : -INFINITY;
  __syncthreads();

  const int ra = blockIdx.y * BT_ROWS + warp * 16 + g, rb = ra + 8;
  if (ra - g >= Sq) return;
  const bool va = ra < Sq, vb = rb < Sq;
  const size_t offa = ((size_t)n * Sq + ra) * E + (size_t)h * BT_HD;
  const size_t offb = ((size_t)n * Sq + rb) * E + (size_t)h * BT_HD;

  // s = q . k^T, then p = exp(s * scale + bias - lse), kept in s
  float s[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < BT_HD / 16; ++ks) {
    uint32_t a[4];
    load_a_fragment(q + offa, q + offb, va, vb, ks * 16 + tig * 2, 1.f, a);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const bf16* kr = Ks + (nt * 8 + g) * BT_STR + ks * 16 + tig * 2;
      const uint32_t b[2] = {ld32(kr), ld32(kr + 8)};
      mma_bf16_16816(s[nt], a, b);
    }
  }
  const float la = va ? lse[((size_t)n * Sq + ra) * H + h] : 0.f;
  const float lb = vb ? lse[((size_t)n * Sq + rb) * H + h] : 0.f;
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
    load_a_fragment(dout + offa, dout + offb, va, vb, ks * 16 + tig * 2, 1.f, doa[ks]);

  // dp tile nt (16 rows x 8 keys) = do . v^T, masked and rescaled
  uint32_t kept[(NT * 4 + 31) / 32];
#pragma unroll
  for (int w = 0; w < (NT * 4 + 31) / 32; ++w) kept[w] = 0u;
  auto dp_tile = [&](int nt, float* dp, bool first) {
    dp[0] = dp[1] = dp[2] = dp[3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < BT_HD / 16; ++ks) {
      const bf16* vr = Vs + (nt * 8 + g) * BT_STR + ks * 16 + tig * 2;
      const uint32_t b[2] = {ld32(vr), ld32(vr + 8)};
      mma_bf16_16816(dp, doa[ks], b);
    }
    if constexpr (DROP) {
      const int bit = nt * 4;  // a tile's four bits never straddle a word
      bool keep[4];
      if (first) {
        dropout_keep_rows(drop, n, h, ra, rb, nt * 8 + tig * 2, tig, keep);
#pragma unroll
        for (int i = 0; i < 4; ++i) kept[bit / 32] |= (uint32_t)keep[i] << (bit % 32 + i);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) keep[i] = (kept[bit / 32] >> (bit % 32 + i)) & 1u;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) dp[i] = keep[i] ? dp[i] * drop.scale : 0.f;
    }
  };

  float dl[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    float dp[4];
    dp_tile(nt, dp, true);
#pragma unroll
    for (int i = 0; i < 4; ++i) dl[i / 2] += s[nt][i] * dp[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    for (int off = 1; off < 4; off <<= 1) dl[r] += __shfl_xor_sync(0xffffffffu, dl[r], off);
  if (tig == 0) {
    if (va) delta[((size_t)n * Sq + ra) * H + h] = dl[0];
    if (vb) delta[((size_t)n * Sq + rb) * H + h] = dl[1];
  }

  // dq = ds . k: the ds tiles 2kt, 2kt+1 are the A fragment of 16-key step kt
  float o[BT_HD / 8][4];
#pragma unroll
  for (int dt = 0; dt < BT_HD / 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    float ds[8];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      float dp[4];
      dp_tile(2 * kt + t, dp, false);
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[4 * t + i] = s[2 * kt + t][i] * (dp[i] - dl[i / 2]) * scale;
    }
    uint32_t a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = pack_bf16(ds[2 * i], ds[2 * i + 1]);
#pragma unroll
    for (int dt = 0; dt < BT_HD / 8; ++dt) {
      const bf16* kr = Kt + (dt * 8 + g) * TSTR + kt * 16 + tig * 2;
      const uint32_t b[2] = {ld32(kr), ld32(kr + 8)};
      mma_bf16_16816(o[dt], a, b);
    }
  }
#pragma unroll
  for (int dt = 0; dt < BT_HD / 8; ++dt) {
    const int d = dt * 8 + tig * 2;
    if (va) *reinterpret_cast<uint32_t*>(dq + offa + d) = pack_bf16(o[dt][0], o[dt][1]);
    if (vb) *reinterpret_cast<uint32_t*>(dq + offb + d) = pack_bf16(o[dt][2], o[dt][3]);
  }
}

// dk and dv. Grid (N * H, ceil(Sk / 64)), 4 warps of 16 keys. The block's K
// and V rows stay in registers as A fragments for the whole walk; each step
// stages 64 query rows of q and do in shared memory, row-major and
// transposed, and works on the transposed tile: s^T = k . q^T and dp^T =
// v . do^T (16 keys x 64 queries per warp), p^T, ds^T, then dk += ds^T . q
// and dv += p_used^T . do into fp32 register accumulators. The walk order
// is fixed, so the sums are bitwise repeatable.
template <bool DROP>
__global__ void __launch_bounds__(BT_WARPS * 32)
flash_bwd_dkv_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        const __nv_bfloat16* __restrict__ dout, __nv_bfloat16* __restrict__ dk,
                        __nv_bfloat16* __restrict__ dv, int Sq, int Sk, int H, float scale,
                        int causal, Dropout drop) {
  using bf16 = __nv_bfloat16;
  constexpr int NT = BT_ROWS / 8;  // 8-query tiles per step
  __shared__ __align__(16) bf16 Qs[BT_ROWS * BT_STR];  // [query][d]
  __shared__ __align__(16) bf16 Ds[BT_ROWS * BT_STR];
  __shared__ __align__(16) bf16 Qt[BT_HD * BT_STR];    // [d][query]
  __shared__ __align__(16) bf16 Dt[BT_HD * BT_STR];
  __shared__ float ls[BT_ROWS], dls[BT_ROWS];

  const int n = blockIdx.x / H, h = blockIdx.x % H, j0 = blockIdx.y * BT_ROWS;
  const size_t E = (size_t)H * BT_HD;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tig = lane & 3;

  const int ka = j0 + warp * 16 + g, kb = ka + 8;
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

  // under the causal mask the rows before the tile's first key see none of
  // its keys: their p is exactly 0
  const int i_begin = causal ? j0 : 0;
  for (int i0 = i_begin; i0 < Sq; i0 += BT_ROWS) {
    __syncthreads();  // the previous step's reads are done
    for (int c = tid; c < BT_ROWS * (BT_HD / 8); c += blockDim.x) {
      const int ii = c / (BT_HD / 8), d0 = (c % (BT_HD / 8)) * 8;
      uint4 qv = make_uint4(0u, 0u, 0u, 0u), dv4 = qv;
      if (i0 + ii < Sq) {
        const size_t gi = ((size_t)n * Sq + i0 + ii) * E + (size_t)h * BT_HD + d0;
        qv = *reinterpret_cast<const uint4*>(q + gi);
        dv4 = *reinterpret_cast<const uint4*>(dout + gi);
      }
      *reinterpret_cast<uint4*>(Qs + ii * BT_STR + d0) = qv;
      *reinterpret_cast<uint4*>(Ds + ii * BT_STR + d0) = dv4;
      const bf16* qe = reinterpret_cast<const bf16*>(&qv);
      const bf16* de = reinterpret_cast<const bf16*>(&dv4);
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        Qt[(d0 + x) * BT_STR + ii] = qe[x];
        Dt[(d0 + x) * BT_STR + ii] = de[x];
      }
    }
    if (tid < BT_ROWS) {
      const bool okrow = i0 + tid < Sq;
      ls[tid] = okrow ? lse[((size_t)n * Sq + i0 + tid) * H + h] : 0.f;
      dls[tid] = okrow ? delta[((size_t)n * Sq + i0 + tid) * H + h] : 0.f;
    }
    __syncthreads();

    // st = (k . q^T) tile, dpt = (v . do^T) tile: rows = keys, cols = queries
    float st[NT][4], dpt[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) st[nt][i] = dpt[nt][i] = 0.f;
#pragma unroll
    for (int ks = 0; ks < BT_HD / 16; ++ks)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const bf16* qr = Qs + (nt * 8 + g) * BT_STR + ks * 16 + tig * 2;
        const uint32_t bq[2] = {ld32(qr), ld32(qr + 8)};
        mma_bf16_16816(st[nt], kf[ks], bq);
        const bf16* dr = Ds + (nt * 8 + g) * BT_STR + ks * 16 + tig * 2;
        const uint32_t bd[2] = {ld32(dr), ld32(dr + 8)};
        mma_bf16_16816(dpt[nt], vf[ks], bd);
      }

    // st <- p_used^T, dpt <- ds^T
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      bool keep[4];
      if constexpr (DROP)
        dropout_keep_keys(drop, n, h, i0 + nt * 8 + tig * 2, ka, kb, lane, keep);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ii = nt * 8 + tig * 2 + (i & 1), iq = i0 + ii;
        const int key = i < 2 ? ka : kb;
        float x = st[nt][i] * scale + (i < 2 ? ba : bb);
        if (causal && key > iq && key < Sk) x = NEG;
        float p = iq < Sq ? expf(x - ls[ii]) : 0.f;
        float dp = dpt[nt][i], pu = p;
        if constexpr (DROP) {
          pu = keep[i] ? p * drop.scale : 0.f;
          dp = keep[i] ? dp * drop.scale : 0.f;
        }
        st[nt][i] = pu;
        dpt[nt][i] = p * (dp - dls[ii]) * scale;
      }
    }

    // dk += ds^T . q, dv += p_used^T . do: query tiles 2kt, 2kt+1 are the A
    // fragment of the kt-th 16-query step
#pragma unroll
    for (int kt = 0; kt < NT / 2; ++kt) {
      uint32_t as[4], ap[4];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        as[2 * t] = pack_bf16(dpt[2 * kt + t][0], dpt[2 * kt + t][1]);
        as[2 * t + 1] = pack_bf16(dpt[2 * kt + t][2], dpt[2 * kt + t][3]);
        ap[2 * t] = pack_bf16(st[2 * kt + t][0], st[2 * kt + t][1]);
        ap[2 * t + 1] = pack_bf16(st[2 * kt + t][2], st[2 * kt + t][3]);
      }
#pragma unroll
      for (int dt = 0; dt < BT_HD / 8; ++dt) {
        const bf16* qr = Qt + (dt * 8 + g) * BT_STR + kt * 16 + tig * 2;
        const uint32_t bq[2] = {ld32(qr), ld32(qr + 8)};
        mma_bf16_16816(ok[dt], as, bq);
        const bf16* dr = Dt + (dt * 8 + g) * BT_STR + kt * 16 + tig * 2;
        const uint32_t bd[2] = {ld32(dr), ld32(dr + 8)};
        mma_bf16_16816(ov[dt], ap, bd);
      }
    }
  }

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

template <int KT, bool DROP>
inline cudaError_t launch_bwd_tc_as(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                    const __nv_bfloat16* v, const float* bias, const float* lse,
                                    const __nv_bfloat16* dout, __nv_bfloat16* dq,
                                    __nv_bfloat16* dk, __nv_bfloat16* dv, float* delta, int N,
                                    int Sq, int Sk, int H, float scale, int causal, Dropout drop,
                                    cudaStream_t stream) {
  constexpr size_t smem = bwd_dq_tc_smem_bytes<KT>();
  auto dq_kernel = flash_bwd_dq_tc_kernel<KT, DROP>;
  cudaError_t e = allow_smem(dq_kernel, smem);
  if (e != cudaSuccess) return e;
  dim3 grid_q(N * H, (Sq + BT_ROWS - 1) / BT_ROWS);
  dq_kernel<<<grid_q, BT_WARPS * 32, smem, stream>>>(q, k, v, bias, lse, dout, dq, delta, Sq, Sk,
                                                     H, scale, causal, drop);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dim3 grid_k(N * H, (Sk + BT_ROWS - 1) / BT_ROWS);
  flash_bwd_dkv_tc_kernel<DROP><<<grid_k, BT_WARPS * 32, 0, stream>>>(
      q, k, v, bias, lse, delta, dout, dk, dv, Sq, Sk, H, scale, causal, drop);
  return cudaGetLastError();
}

inline int bwd_tc_key_tiles(int Sk) {
  const int kt = (Sk + 15) / 16;
  return kt <= 3 ? 3 : kt <= 8 ? 8 : kt <= 14 ? 14 : 16;
}

inline size_t bwd_tc_smem_bytes(int Sk) {
  switch (bwd_tc_key_tiles(Sk)) {
    case 3: return bwd_dq_tc_smem_bytes<3>();
    case 8: return bwd_dq_tc_smem_bytes<8>();
    case 14: return bwd_dq_tc_smem_bytes<14>();
    default: return bwd_dq_tc_smem_bytes<16>();
  }
}

inline cudaError_t launch_bwd_tc(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                 const __nv_bfloat16* v, const float* bias, const float* lse,
                                 const __nv_bfloat16* dout, __nv_bfloat16* dq, __nv_bfloat16* dk,
                                 __nv_bfloat16* dv, float* delta, int N, int Sq, int Sk, int H,
                                 float scale, int causal, Dropout drop, cudaStream_t stream) {
#define FF_BWD_TC(KT)                                                                          \
  return drop.on() ? launch_bwd_tc_as<KT, true>(q, k, v, bias, lse, dout, dq, dk, dv, delta, N, \
                                                Sq, Sk, H, scale, causal, drop, stream)        \
                   : launch_bwd_tc_as<KT, false>(q, k, v, bias, lse, dout, dq, dk, dv, delta,  \
                                                 N, Sq, Sk, H, scale, causal, drop, stream)
  switch (bwd_tc_key_tiles(Sk)) {
    case 3: FF_BWD_TC(3);
    case 8: FF_BWD_TC(8);
    case 14: FF_BWD_TC(14);
    default: FF_BWD_TC(16);
  }
#undef FF_BWD_TC
}

}  // namespace ff
