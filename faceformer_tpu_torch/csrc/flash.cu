// K2: flash attention forward, the Hopper counterpart of
// faceformer_tpu/ops/flash.py::flash_attention's forward (pl.pallas_call at
// flash.py:252; kernel _fwd_kernel :118-137, wrapper _flash_fwd_impl
// :241-265). The backward (flash.py:293) is flash_bwd.cu.
//
// What it computes: softmax(q . k^T * hd^-0.5 + bias) . v per head on the
// packed (N, S, H*hd) layout, with an optional causal mask, plus the
// (N, Sq, H) fp32 logsumexp. bias is the additive (N, Sk) key-padding bias
// (0 or the float32 minimum). In training the probabilities are dropped
// inside the kernel (flash.py:131-133) with the counter-based keep mask of
// common.cuh; threshold 0 means no dropout and runs the dropout-free
// instantiation.
//
// What bounds it here: memory. At the training step's cross-attention
// (q (32, 8640, 8, 64) against k, v (32, 220, 8, 64), bf16) q and out are
// 283 MB each and K, V, lse and the bias ~16 MB more: ~0.59 GB, 0.176 ms
// at 3.35 TB/s, against ~100 GFLOP of products (0.1 ms on the bf16 tensor
// cores). The decoder self-attention (6,912 sequences of 40) moves 1.13
// GB (0.338 ms); the serving encoder (N=20, S=220) ~18 MB (5.4 us).
//
// Design: the anchor-parallel paths' key sides have Sk <= 220, so one
// (sequence, head)'s K and V sit in shared memory whole and the softmax is
// exact, not online, as in the Pallas kernel. bf16 at hd = 64 runs the
// tensor-core kernel of attention.cuh; fp32 and other head dims run its
// CUDA-core kernel. The tensor-core kernel reads each byte of the call
// once from device memory: a block copies its (sequence, head)'s K, V and
// bias into shared memory once by cp.async and walks that pair's query
// tiles through a cp.async ring (the next tile's copy under this tile's
// products), so the key side is not re-staged for every 64 query rows
// (~2 GB of L2 traffic at the cross shape when it was). V's B fragments
// come by ldmatrix.trans from V as it lies, not from a transposed copy
// made by scalar stores. Sequences of one tile (the decoder's 37-40 rows)
// are walked a pair at a time, each ring stage holding a whole pair, so a
// block's next key side arrives while it computes the current one. The
// output leaves through shared memory as 16-byte stores. Blocks: the
// card's resident count, so one wave covers the call.
//
// Long key sides. Past the whole-row tensor-core kernel's TC_MAX_SK = 256
// keys, bf16 at hd = 64 (the flat model's decoder self-attention at
// label_seq_length 512, its reference engine's 512-key prefix buffer, the
// JAX kernel's reach of ~2,000 keys at its 16 MB VMEM budget) runs
// attention_tiled_tc_kernel (attention_tiled_tc.cuh): the whole-row
// tensor-core forward walked over 64-key tiles, twice. Every other call
// past 256 keys (fp32, and bf16 at other head dims; hd = 32 only where its
// whole-row kernel does not fit, see flash_tiled), and any call whose
// whole-row kernel would need more shared memory than a block has, runs
// attention_tiled_kernel below: every shape up to 256 keys keeps the
// kernel it ran before. The CUDA-core tiled kernel stages ATT_TILE_KEYS keys
// at a time and walks them twice, as the CUDA-core kernel walks its staged
// row: pass 1 finds each row's max and sum of exponentials (rescaled from
// tile to tile), which give lse; pass 2 recomputes the scores, forms p =
// exp(s - max) / sum, drops it with the keep bits of the GLOBAL key index,
// rounds it to q's dtype before the product with v as flash.py:118-138
// does, and accumulates p . v in registers. Online rescaling of the output
// would round other quantities than the reference does; the two passes
// keep its arithmetic at the price of a second q . k^T. Under the causal
// mask the tiles past a block's last row are skipped while every row keeps
// a live key in the tiles it visits (their p is exactly 0; as in the dk/dv
// kernel of flash_bwd.cu). Bound: the scores' FMAs on the CUDA cores, each
// reading a key element from shared memory; a simple kernel first.

#include "attention_tiled_tc.cuh"

namespace ff {

constexpr int ATT_TILE_KEYS = 128;  // keys a tile: a multiple of 32, so lanes keep their keys

template <typename TK> inline size_t attention_tiled_smem_bytes(int hd) {
  const size_t ks = ((size_t)ATT_TILE_KEYS * (hd + kv_pad<TK>()) * sizeof(TK) + 15) / 16 * 16;
  const size_t vs = ((size_t)ATT_TILE_KEYS * hd * sizeof(TK) + 15) / 16 * 16;
  return ks + vs + (size_t)ATT_ROWS * hd * 4 + (size_t)ATT_WARPS * ATT_TILE_KEYS * 4;
}

// Grid (N * H, ceil(Sq / ATT_ROWS)), ATT_WARPS warps; warp w owns rows
// w, w + ATT_WARPS, ... of the block's ATT_ROWS, lanes split a tile's keys
// for the scores and hd (DC values a lane) for the output.
template <typename TQ, typename TK, bool DROP, int DC>
__global__ void __launch_bounds__(ATT_WARPS * 32)
attention_tiled_kernel(const TQ* __restrict__ q, const TK* __restrict__ k,
                       const TK* __restrict__ v, const float* __restrict__ bias,
                       TQ* __restrict__ out, float* __restrict__ lse, int Sq, int Sk, int H,
                       int hd, float scale, int causal, Dropout drop) {
  constexpr int KT = ATT_TILE_KEYS, RPW = ATT_ROWS / ATT_WARPS;
  extern __shared__ __align__(16) unsigned char smem[];
  const int kstride = hd + kv_pad<TK>();
  const size_t ks_bytes = ((size_t)KT * kstride * sizeof(TK) + 15) / 16 * 16;
  const size_t vs_bytes = ((size_t)KT * hd * sizeof(TK) + 15) / 16 * 16;
  TK* Ks = reinterpret_cast<TK*>(smem);
  TK* Vs = reinterpret_cast<TK*>(smem + ks_bytes);
  float* qs = reinterpret_cast<float*>(smem + ks_bytes + vs_bytes);
  float* pw = qs + ATT_ROWS * hd + (threadIdx.x / 32) * KT;

  const int n = blockIdx.x / H, h = blockIdx.x % H, i0 = blockIdx.y * ATT_ROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t E = (size_t)H * hd;
  const float* bias_n = bias + (size_t)n * Sk;
  // under the causal mask the tiles up to the block's last row, if a live
  // key j <= i0 keeps every row's max finite (else a row whose keys are
  // all masked spreads its p over every key, as the reference's does)
  int j_end = Sk;
  if (causal) {
    const int probe = min(min(i0 + 1, Sk), (int)blockDim.x);
    if (__syncthreads_or(threadIdx.x < probe && bias_n[threadIdx.x] > NEG))
      j_end = min(Sk, i0 + ATT_ROWS);
  }
  const int tiles = (j_end + KT - 1) / KT;

  for (int idx = threadIdx.x; idx < ATT_ROWS * hd; idx += blockDim.x) {
    const int r = idx / hd, d = idx % hd;
    qs[idx] = i0 + r < Sq ? to_f(q[((size_t)n * Sq + i0 + r) * E + (size_t)h * hd + d]) : 0.f;
  }

  // the scores of keys j0 + lane, j0 + lane + 32, ... of row r into pw
  auto scores = [&](int r, int j0, int nk) {
    const float* qw = qs + r * hd;
    for (int jj = lane; jj < nk; jj += 32) {
      const TK* kj = Ks + jj * kstride;
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s = fmaf(qw[d], to_f(kj[d]), s);
      s *= scale;
      s += bias_n[j0 + jj];
      if (causal && j0 + jj > i0 + r) s = NEG;
      pw[jj] = s;
    }
  };
  auto stage = [&](int j0, int nk, bool with_v) {
    __syncthreads();  // the previous tile's reads are done
    for (int idx = threadIdx.x; idx < nk * hd; idx += blockDim.x) {
      const int jj = idx / hd, d = idx % hd;
      const size_t g = ((size_t)n * Sk + j0 + jj) * E + (size_t)h * hd + d;
      Ks[jj * kstride + d] = k[g];
      if (with_v) Vs[jj * hd + d] = v[g];
    }
    __syncthreads();
  };

  // pass 1: row max and sum of exponentials, tile by tile
  float m[RPW], l[RPW];
#pragma unroll
  for (int t = 0; t < RPW; ++t) m[t] = -INFINITY, l[t] = 0.f;
  for (int tile = 0; tile < tiles; ++tile) {
    const int j0 = tile * KT, nk = min(KT, Sk - j0);
    stage(j0, nk, false);
#pragma unroll
    for (int t = 0; t < RPW; ++t) {
      const int r = warp + t * ATT_WARPS;
      if (i0 + r < Sq) {
        scores(r, j0, nk);
        float mx = -INFINITY;
        for (int jj = lane; jj < nk; jj += 32) mx = fmaxf(mx, pw[jj]);
        const float m_new = fmaxf(m[t], warp_max(mx));
        float sum = 0.f;
        for (int jj = lane; jj < nk; jj += 32) sum += expf(pw[jj] - m_new);
        l[t] = l[t] * expf(m[t] - m_new) + warp_sum(sum);
        m[t] = m_new;
      }
    }
  }
  // pass 2: p = exp(s - m) / l (not exp(s - lse): where every key of a row
  // is masked, lse rounds to m and that would give 1, not 1 / Sk), dropped
  // and rounded, times v
  float acc[RPW][DC];
#pragma unroll
  for (int t = 0; t < RPW; ++t)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[t][c] = 0.f;
  for (int tile = 0; tile < tiles; ++tile) {
    const int j0 = tile * KT, nk = min(KT, Sk - j0);
    stage(j0, nk, true);
#pragma unroll
    for (int t = 0; t < RPW; ++t) {
      const int r = warp + t * ATT_WARPS, i = i0 + r;
      if (i < Sq) {
        scores(r, j0, nk);
        for (int jj = lane; jj < nk; jj += 32) {
          float p = expf(pw[jj] - m[t]) / l[t];
          if constexpr (DROP) p = dropout_keep(drop, n, h, i, j0 + jj) ? p * drop.scale : 0.f;
          pw[jj] = round_to<TQ>(p);
        }
        __syncwarp();
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const int d = lane + 32 * c;
          if (d < hd) {
            float a = acc[t][c];
            for (int jj = 0; jj < nk; ++jj) a = fmaf(pw[jj], to_f(Vs[jj * hd + d]), a);
            acc[t][c] = a;
          }
        }
        __syncwarp();
      }
    }
  }

#pragma unroll
  for (int t = 0; t < RPW; ++t) {
    const int i = i0 + warp + t * ATT_WARPS;
    if (i < Sq) {
      const size_t qoff = ((size_t)n * Sq + i) * E + (size_t)h * hd;
#pragma unroll
      for (int c = 0; c < DC; ++c)
        if (lane + 32 * c < hd) out[qoff + lane + 32 * c] = from_f<TQ>(acc[t][c]);
      if (lane == 0) lse[((size_t)n * Sq + i) * H + h] = m[t] + logf(l[t]);
    }
  }
}

// Head dims the tiled kernel takes: DC = ceil(hd / 32) <= 4.
constexpr int ATT_TILED_MAX_HD = 128;

template <typename TQ, typename TK, bool DROP>
inline cudaError_t launch_attention_tiled(const TQ* q, const TK* k, const TK* v,
                                          const float* bias, TQ* out, float* lse, int N, int Sq,
                                          int Sk, int H, int hd, float scale, int causal,
                                          cudaStream_t stream, Dropout drop) {
  const size_t smem = attention_tiled_smem_bytes<TK>(hd);
  const dim3 grid(N * H, (Sq + ATT_ROWS - 1) / ATT_ROWS);
#define FF_ATT_TILED(DC)                                                                       \
  {                                                                                            \
    auto kernel = attention_tiled_kernel<TQ, TK, DROP, DC>;                                    \
    cudaError_t e = allow_smem(kernel, smem);                                                  \
    if (e != cudaSuccess) return e;                                                            \
    kernel<<<grid, ATT_WARPS * 32, smem, stream>>>(q, k, v, bias, out, lse, Sq, Sk, H, hd,     \
                                                   scale, causal, drop);                       \
    return cudaGetLastError();                                                                 \
  }
  if (hd <= 32) FF_ATT_TILED(1)
  if (hd <= 64) FF_ATT_TILED(2)
  if (hd <= ATT_TILED_MAX_HD) FF_ATT_TILED(4)
#undef FF_ATT_TILED
  return cudaErrorInvalidValue;
}

// The kernel the call takes: the whole-row kernels up to TC_MAX_SK keys
// where they fit a block's shared memory, else a key-tiled one: the
// tensor-core kernel for bf16 at hd = 64, the CUDA-core kernel otherwise.
// hd = 32 keeps the whole-row kernels past TC_MAX_SK keys wherever they
// fit: timed against them (tools/time_key_tiles.py), the CUDA-core tiled
// kernel lost there at 512 queries against 320 keys in both dtypes (1.22 x
// fp32, 1.55 x bf16), where at hd = 64 it won at every shape.
// Builds for tools/time_key_tiles.py: FF_KEY_TILES_ALWAYS sends every call
// to a key-tiled kernel; FF_WHOLE_ROWS keeps the whole-row kernels wherever
// they fit a block (the dispatch before the tensor-core tiled kernel);
// FF_CUDA_CORE_TILES keeps bf16 at hd = 64 off the tensor-core tiled kernel.
inline size_t whole_row_smem_bytes(int dtype, int Sk, int hd) {
  if (dtype == FF_FLOAT32) return attention_smem_bytes<float>(Sk, hd);
  return takes_tc(Sk, hd) ? tc_smem_for<__nv_bfloat16>(Sk)
                          : attention_smem_bytes<__nv_bfloat16>(Sk, hd);
}
inline bool flash_tiled(int dtype, int Sk, int hd) {
#if defined(FF_KEY_TILES_ALWAYS)
  return true;
#elif defined(FF_WHOLE_ROWS)
  return whole_row_smem_bytes(dtype, Sk, hd) > SMEM_LIMIT;
#else
  return (Sk > TC_MAX_SK && hd != 32) || whole_row_smem_bytes(dtype, Sk, hd) > SMEM_LIMIT;
#endif
}
inline bool tiled_on_tc(int dtype, int hd) {
#ifdef FF_CUDA_CORE_TILES
  return false;
#else
  return dtype == FF_BFLOAT16 && hd == TC_HD;
#endif
}

}  // namespace ff

template <bool DROP>
static int flash_fwd_impl(int dtype, const void* q, const void* k, const void* v, const float* b,
                          int N, int Sq, int Sk, int H, int hd, float scale, int causal,
                          ff::Dropout drop, void* out, float* l, cudaStream_t st) {
  if (ff::flash_tiled(dtype, Sk, hd)) {
    if (ff::tiled_on_tc(dtype, hd))
      return ff::launch_attention_tiled_tc<DROP>(
          static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v), b, static_cast<__nv_bfloat16*>(out), l, N, Sq,
          Sk, H, scale, causal, drop, st);
    if (dtype == FF_FLOAT32)
      return ff::launch_attention_tiled<float, float, DROP>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), b, static_cast<float*>(out), l, N, Sq, Sk, H, hd, scale,
          causal, st, drop);
    if (dtype == FF_BFLOAT16)
      return ff::launch_attention_tiled<__nv_bfloat16, __nv_bfloat16, DROP>(
          static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v), b, static_cast<__nv_bfloat16*>(out), l, N, Sq,
          Sk, H, hd, scale, causal, st, drop);
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == FF_FLOAT32)
    return ff::launch_attention<float, float, false, DROP>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), b, static_cast<float*>(out), l, N, Sq, Sk, H, hd, scale,
        causal, st, drop);
  if (dtype == FF_BFLOAT16)
    return ff::launch_attention<__nv_bfloat16, __nv_bfloat16, false, DROP>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), b, static_cast<__nv_bfloat16*>(out), l, N, Sq, Sk,
        H, hd, scale, causal, st, drop);
  return (int)cudaErrorInvalidValue;
}

FF_EXPORT int flash_fwd(int dtype, const void* q, const void* k, const void* v,
                        const void* bias, int N, int Sq, int Sk, int H, int hd, float scale,
                        int causal, unsigned long long seed, unsigned int threshold,
                        float drop_scale, unsigned int head0, void* out, void* lse,
                        void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto b = static_cast<const float*>(bias);
  auto l = static_cast<float*>(lse);
  const ff::Dropout drop = ff::make_dropout(seed, threshold, drop_scale, head0);
  if (drop.on())
    return flash_fwd_impl<true>(dtype, q, k, v, b, N, Sq, Sk, H, hd, scale, causal, drop, out,
                                l, st);
  return flash_fwd_impl<false>(dtype, q, k, v, b, N, Sq, Sk, H, hd, scale, causal, drop, out, l,
                               st);
}

// The dynamic shared memory of the kernel that takes (dtype, Sk, hd): the
// whole-row tensor-core kernel's larger walk or the CUDA-core kernel's, or
// a key-tiled kernel's (more than a block has only where even one tile of
// the CUDA-core kernel does not fit: hd past ATT_TILED_MAX_HD).
FF_EXPORT size_t flash_smem_bytes(int dtype, int Sk, int hd) {
  if (!ff::flash_tiled(dtype, Sk, hd)) return ff::whole_row_smem_bytes(dtype, Sk, hd);
  if (ff::tiled_on_tc(dtype, hd)) return ff::TT_SMEM_BYTES;
  if (hd > ff::ATT_TILED_MAX_HD) return (size_t)-1;
  return dtype == FF_FLOAT32 ? ff::attention_tiled_smem_bytes<float>(hd)
                             : ff::attention_tiled_smem_bytes<__nv_bfloat16>(hd);
}

// Keys a tile of the kernel that takes (dtype, Sk, hd); 0: the whole key
// side is staged at once.
FF_EXPORT int flash_key_tile(int dtype, int Sk, int hd) {
  if (!ff::flash_tiled(dtype, Sk, hd)) return 0;
  return ff::tiled_on_tc(dtype, hd) ? ff::TT_KEYS : ff::ATT_TILE_KEYS;
}

// The keep mask alone, as bytes (N, H, Sq, Sk): what both flash kernels apply
// for this seed and first head, for holding it against
// ops/flash.py::philox_keep_mask.
__global__ void keep_mask_kernel(ff::Dropout drop, int H, int Sq, int Sk,
                                 unsigned char* __restrict__ out, size_t total) {
  for (size_t idx = blockIdx.x * (size_t)blockDim.x + threadIdx.x; idx < total;
       idx += (size_t)gridDim.x * blockDim.x) {
    const int j = (int)(idx % Sk);
    const int i = (int)(idx / Sk % Sq);
    const int h = (int)(idx / ((size_t)Sk * Sq) % H);
    const int n = (int)(idx / ((size_t)Sk * Sq * H));
    out[idx] = ff::dropout_keep(drop, n, h, i, j) ? 1 : 0;
  }
}

FF_EXPORT int flash_keep_mask(unsigned long long seed, unsigned int threshold,
                              unsigned int head0, int N, int H, int Sq, int Sk, void* out,
                              void* stream) {
  const size_t total = (size_t)N * H * Sq * Sk;
  const int blocks = (int)((total + 255) / 256 < 65535 * 16 ? (total + 255) / 256 : 65535 * 16);
  keep_mask_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      ff::make_dropout(seed, threshold, 1.f, head0), H, Sq, Sk, static_cast<unsigned char*>(out),
      total);
  return (int)cudaGetLastError();
}
