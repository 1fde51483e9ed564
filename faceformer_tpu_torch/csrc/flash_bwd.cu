// K3: flash attention backward, the Hopper counterpart of
// faceformer_tpu/ops/flash.py::_flash_bwd (pl.pallas_call at flash.py:293;
// kernel _bwd_kernel :140-186).
//
// What it computes, per (sequence, head), from q, k, v, do, the key-padding
// bias and the forward's logsumexp (no stored probabilities):
//   s = q . k^T * scale + bias (NEG above the diagonal when causal)
//   p = exp(s - lse)                      pre-dropout probabilities
//   dp = do . v^T                         (kept ? dp * 1/(1 - rate) : 0)
//   delta = sum_k p * dp ;  ds = p * (dp - delta) * scale
//   dq = ds . k ;  dk = sum_q ds^T . q ;  dv = sum_q p_used^T . do
// with p_used = kept ? p * 1/(1 - rate) : 0 and the keep mask of common.cuh,
// the same bits the forward drew for this seed. Masked entries give
// exp(NEG - lse) = 0 exactly, never NaN.
//
// What bounds it here, at the training shapes (bf16, hd = 64, N = 32):
// the encoder call (220 x 220 per (sample, head)) and the decoder-self call
// (6,912 x 8 pairs of 40 x 40, causal) are byte-bound (0.015 and 0.59 ms of
// HBM traffic at least); the cross-attention call (8,640 queries against
// 220 keys per pair) does 0.31 TFLOP against 0.85 GB and is
// operation-bound. The kernels run eight products where five are the
// minimum, and with dropout one Philox call per four elements in each.
//
// Design. The TPU grid revisits one dk/dv block for every query block in
// order; CUDA blocks run in no order, so the backward is two kernels and
// no atomics, which makes every gradient bitwise repeatable:
//   1. dq: a block holds the whole key side of its (sequence, head) (Sk <=
//      a few hundred on every path) in shared memory, loaded once, and
//      walks a share of the query tiles, so delta is an exact row sum as in
//      the Pallas kernel. It also writes delta (N, Sq, H).
//   2. dk, dv: a block is stationary over a tile of keys and walks every
//      query row in a fixed order, reading delta; the accumulators stay in
//      registers.
// Both recompute s and dp. fp32 inputs (and head dims other than 64) run
// the CUDA-core kernels, everything in fp32 after the loads as the Pallas
// kernel. bf16 at hd = 64 and Sk <= 256 runs the mma.sync kernels of
// flash_bwd_tc.cuh (ring, key tiling and splits are described there): s
// and dp accumulate in fp32 from bf16 fragments, the softmax algebra is
// fp32, and ds, p_used are rounded to bf16 for the three products that
// follow, where the Pallas kernel keeps fp32.

#include "common.cuh"

namespace ff {

// ---------------------------------------------------------------------------
// CUDA-core kernels (any dtype, hd <= 64 for dk/dv)
// ---------------------------------------------------------------------------
constexpr int BWD_WARPS = 8;
constexpr int BWD_ROWS = 32;  // query rows per dq block: 4 per warp

inline size_t bwd_dq_smem_bytes(int Sk, int hd) {
  return ((size_t)2 * Sk * (hd + 1) + (size_t)BWD_WARPS * 2 * (hd + Sk)) * sizeof(float);
}

// Grid (N * H, ceil(Sq / BWD_ROWS)). K and V of the (sequence, head) sit in
// shared memory in fp32; one warp walks one query row at a time: lanes
// split the keys for s, dp and ds, then split hd for dq = ds . k.
template <typename T>
__global__ void __launch_bounds__(BWD_WARPS * 32)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const float* __restrict__ bias, const float* __restrict__ lse,
                    const T* __restrict__ dout, T* __restrict__ dq, float* __restrict__ delta,
                    int Sq, int Sk, int H, int hd, float scale, int causal, Dropout drop) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int kstride = hd + 1;
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + (size_t)Sk * kstride;
  float* qs = Vs + (size_t)Sk * kstride;
  float* dos = qs + BWD_WARPS * hd;
  float* ps = dos + BWD_WARPS * hd;
  float* dps = ps + BWD_WARPS * Sk;

  const int n = blockIdx.x / H, h = blockIdx.x % H, tile = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t E = (size_t)H * hd;

  for (int idx = threadIdx.x; idx < Sk * hd; idx += blockDim.x) {
    const int j = idx / hd, d = idx % hd;
    const size_t g = ((size_t)n * Sk + j) * E + (size_t)h * hd + d;
    Ks[j * kstride + d] = to_f(k[g]);
    Vs[j * kstride + d] = to_f(v[g]);
  }
  __syncthreads();

  float* qw = qs + warp * hd;
  float* dow = dos + warp * hd;
  float* pw = ps + warp * Sk;
  float* dpw = dps + warp * Sk;
  const float* bias_n = bias + (size_t)n * Sk;
  const int row_end = min(Sq, (tile + 1) * BWD_ROWS);
  for (int i = tile * BWD_ROWS + warp; i < row_end; i += BWD_WARPS) {
    const size_t qoff = ((size_t)n * Sq + i) * E + (size_t)h * hd;
    for (int d = lane; d < hd; d += 32) {
      qw[d] = to_f(q[qoff + d]);
      dow[d] = to_f(dout[qoff + d]);
    }
    __syncwarp();
    const float l = lse[((size_t)n * Sq + i) * H + h];

    float part = 0.f;
    for (int j = lane; j < Sk; j += 32) {
      const float* kj = Ks + j * kstride;
      const float* vj = Vs + j * kstride;
      float s = 0.f, dp = 0.f;
      for (int d = 0; d < hd; ++d) {
        s = fmaf(qw[d], kj[d], s);
        dp = fmaf(dow[d], vj[d], dp);
      }
      s = s * scale + bias_n[j];
      if (causal && j > i) s = NEG;
      const float p = expf(s - l);
      if (drop.on()) dp = dropout_keep(drop, n, h, i, j) ? dp * drop.scale : 0.f;
      part += p * dp;
      pw[j] = p;
      dpw[j] = dp;
    }
    const float dl = warp_sum(part);
    for (int j = lane; j < Sk; j += 32) pw[j] = pw[j] * (dpw[j] - dl) * scale;
    if (lane == 0) delta[((size_t)n * Sq + i) * H + h] = dl;
    __syncwarp();

    for (int d = lane; d < hd; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < Sk; ++j) acc = fmaf(pw[j], Ks[j * kstride + d], acc);
      dq[qoff + d] = from_f<T>(acc);
    }
    __syncwarp();
  }
}

constexpr int KV_THREADS = 256;
constexpr int KV_KEYS = 32;     // keys per dk/dv block
constexpr int KV_QROWS = 32;    // query rows per step of the walk
constexpr int KV_ACC = 8;       // accumulators per thread: KV_KEYS * hd <= 256 * 8
constexpr int KV_MAX_HD = KV_THREADS * KV_ACC / KV_KEYS;

inline size_t bwd_dkv_smem_bytes(int hd) {
  return ((size_t)(2 * KV_KEYS + 2 * KV_QROWS) * (hd + 1) + (size_t)2 * KV_QROWS * (KV_KEYS + 1) +
          2 * KV_QROWS + KV_KEYS) * sizeof(float);
}

// Grid (N * H, ceil(Sk / KV_KEYS)). The block keeps its key tile of K and V
// in shared memory and walks the query rows KV_QROWS at a time, always in
// the same order: it recomputes the (rows x keys) tile of p_used and ds
// into shared memory, then every thread adds the tile's contribution to
// its KV_ACC entries of dk and dv, held in registers until the end.
template <typename T>
__global__ void __launch_bounds__(KV_THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const float* __restrict__ bias, const float* __restrict__ lse,
                     const float* __restrict__ delta, const T* __restrict__ dout,
                     T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk, int H, int hd,
                     float scale, int causal, Dropout drop) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rs = hd + 1, ts = KV_KEYS + 1;
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + KV_KEYS * rs;
  float* Qs = Vs + KV_KEYS * rs;
  float* Ds = Qs + KV_QROWS * rs;
  float* Pu = Ds + KV_QROWS * rs;
  float* dS = Pu + KV_QROWS * ts;
  float* ls = dS + KV_QROWS * ts;
  float* dls = ls + KV_QROWS;
  float* bs = dls + KV_QROWS;

  const int n = blockIdx.x / H, h = blockIdx.x % H, j0 = blockIdx.y * KV_KEYS;
  const int nk = min(KV_KEYS, Sk - j0);
  const int tid = threadIdx.x;
  const size_t E = (size_t)H * hd;

  for (int idx = tid; idx < KV_KEYS * hd; idx += KV_THREADS) {
    const int jj = idx / hd, d = idx % hd;
    float kv = 0.f, vv = 0.f;
    if (jj < nk) {
      const size_t g = ((size_t)n * Sk + j0 + jj) * E + (size_t)h * hd + d;
      kv = to_f(k[g]);
      vv = to_f(v[g]);
    }
    Ks[jj * rs + d] = kv;
    Vs[jj * rs + d] = vv;
  }
  if (tid < KV_KEYS) bs[tid] = tid < nk ? bias[(size_t)n * Sk + j0 + tid] : 0.f;

  float acc_k[KV_ACC], acc_v[KV_ACC];
#pragma unroll
  for (int r = 0; r < KV_ACC; ++r) acc_k[r] = acc_v[r] = 0.f;

  // under the causal mask the rows before the tile's first key see none of
  // its keys: their p is exactly 0
  const int i_begin = causal ? (j0 / KV_QROWS) * KV_QROWS : 0;
  for (int i0 = i_begin; i0 < Sq; i0 += KV_QROWS) {
    __syncthreads();  // the previous step's reads of Qs, Ds, Pu, dS are done
    for (int idx = tid; idx < KV_QROWS * hd; idx += KV_THREADS) {
      const int ii = idx / hd, d = idx % hd;
      float qv = 0.f, dv_ = 0.f;
      if (i0 + ii < Sq) {
        const size_t g = ((size_t)n * Sq + i0 + ii) * E + (size_t)h * hd + d;
        qv = to_f(q[g]);
        dv_ = to_f(dout[g]);
      }
      Qs[ii * rs + d] = qv;
      Ds[ii * rs + d] = dv_;
    }
    if (tid < KV_QROWS) {
      const bool ok = i0 + tid < Sq;
      ls[tid] = ok ? lse[((size_t)n * Sq + i0 + tid) * H + h] : 0.f;
      dls[tid] = ok ? delta[((size_t)n * Sq + i0 + tid) * H + h] : 0.f;
    }
    __syncthreads();

    for (int e = tid; e < KV_QROWS * KV_KEYS; e += KV_THREADS) {
      const int ii = e / KV_KEYS, jj = e % KV_KEYS;
      const int i = i0 + ii, j = j0 + jj;
      float pu = 0.f, ds = 0.f;
      if (i < Sq && jj < nk) {
        const float* qi = Qs + ii * rs;
        const float* di = Ds + ii * rs;
        const float* kj = Ks + jj * rs;
        const float* vj = Vs + jj * rs;
        float s = 0.f, dp = 0.f;
        for (int d = 0; d < hd; ++d) {
          s = fmaf(qi[d], kj[d], s);
          dp = fmaf(di[d], vj[d], dp);
        }
        s = s * scale + bs[jj];
        if (causal && j > i) s = NEG;
        const float p = expf(s - ls[ii]);
        pu = p;
        if (drop.on()) {
          const bool keep = dropout_keep(drop, n, h, i, j);
          pu = keep ? p * drop.scale : 0.f;
          dp = keep ? dp * drop.scale : 0.f;
        }
        ds = p * (dp - dls[ii]) * scale;
      }
      Pu[ii * ts + jj] = pu;
      dS[ii * ts + jj] = ds;
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < KV_ACC; ++r) {
      const int e = tid + KV_THREADS * r;
      if (e < KV_KEYS * hd) {
        const int jj = e / hd, d = e % hd;
        float ak = acc_k[r], av = acc_v[r];
        for (int ii = 0; ii < KV_QROWS; ++ii) {
          ak = fmaf(dS[ii * ts + jj], Qs[ii * rs + d], ak);
          av = fmaf(Pu[ii * ts + jj], Ds[ii * rs + d], av);
        }
        acc_k[r] = ak;
        acc_v[r] = av;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < KV_ACC; ++r) {
    const int e = tid + KV_THREADS * r;
    if (e < KV_KEYS * hd) {
      const int jj = e / hd, d = e % hd;
      if (jj < nk) {
        const size_t g = ((size_t)n * Sk + j0 + jj) * E + (size_t)h * hd + d;
        dk[g] = from_f<T>(acc_k[r]);
        dv[g] = from_f<T>(acc_v[r]);
      }
    }
  }
}

template <typename T>
inline cudaError_t launch_bwd_cores(const T* q, const T* k, const T* v, const float* bias,
                                    const float* lse, const T* dout, T* dq, T* dk, T* dv,
                                    float* delta, int N, int Sq, int Sk, int H, int hd,
                                    float scale, int causal, Dropout drop, cudaStream_t stream) {
  if (hd > KV_MAX_HD) return cudaErrorInvalidValue;
  {
    const size_t smem = bwd_dq_smem_bytes(Sk, hd);
    auto kernel = flash_bwd_dq_kernel<T>;
    cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    dim3 grid(N * H, (Sq + BWD_ROWS - 1) / BWD_ROWS);
    kernel<<<grid, BWD_WARPS * 32, smem, stream>>>(q, k, v, bias, lse, dout, dq, delta, Sq, Sk,
                                                   H, hd, scale, causal, drop);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  const size_t smem = bwd_dkv_smem_bytes(hd);
  auto kernel = flash_bwd_dkv_kernel<T>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(N * H, (Sk + KV_KEYS - 1) / KV_KEYS);
  kernel<<<grid, KV_THREADS, smem, stream>>>(q, k, v, bias, lse, delta, dout, dk, dv, Sq, Sk, H,
                                             hd, scale, causal, drop);
  return cudaGetLastError();
}

}  // namespace ff

#include "flash_bwd_tc.cuh"

// The call runs the tensor-core kernels of flash_bwd_tc.cuh.
static bool bwd_tensor_cores(int dtype, int Sk, int hd) {
  return dtype == FF_BFLOAT16 && hd == ff::BT_HD && Sk <= ff::BT_MAX_SK;
}

FF_EXPORT int flash_bwd(int dtype, const void* q, const void* k, const void* v, const void* bias,
                        const void* lse, const void* dout, int N, int Sq, int Sk, int H, int hd,
                        float scale, int causal, unsigned long long seed, unsigned int threshold,
                        float drop_scale, void* dq, void* dk, void* dv, void* delta,
                        void* keep_bits, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto b = static_cast<const float*>(bias);
  auto l = static_cast<const float*>(lse);
  auto dl = static_cast<float*>(delta);
  const ff::Dropout drop = ff::make_dropout(seed, threshold, drop_scale);
  if (dtype == FF_FLOAT32)
    return ff::launch_bwd_cores<float>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        b, l, static_cast<const float*>(dout), static_cast<float*>(dq), static_cast<float*>(dk),
        static_cast<float*>(dv), dl, N, Sq, Sk, H, hd, scale, causal, drop, st);
  if (dtype == FF_BFLOAT16) {
    using bf16 = __nv_bfloat16;
    auto qb = static_cast<const bf16*>(q), kb = static_cast<const bf16*>(k);
    auto vb = static_cast<const bf16*>(v), db = static_cast<const bf16*>(dout);
    auto dqb = static_cast<bf16*>(dq), dkb = static_cast<bf16*>(dk), dvb = static_cast<bf16*>(dv);
    if (bwd_tensor_cores(dtype, Sk, hd))
      return ff::launch_bwd_tc(qb, kb, vb, b, l, db, dqb, dkb, dvb, dl,
                               static_cast<uint32_t*>(keep_bits), N, Sq, Sk, H, scale, causal,
                               drop, st);
    return ff::launch_bwd_cores<bf16>(qb, kb, vb, b, l, db, dqb, dkb, dvb, dl, N, Sq, Sk, H, hd,
                                      scale, causal, drop, st);
  }
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory the call's kernels need (the larger of the two),
// so the wrapper can refuse a key length that does not fit.
FF_EXPORT size_t flash_bwd_smem_bytes(int dtype, int Sk, int hd) {
  if (bwd_tensor_cores(dtype, Sk, hd)) return ff::bwd_tc_smem_bytes(Sk);
  const size_t a = ff::bwd_dq_smem_bytes(Sk, hd), b = ff::bwd_dkv_smem_bytes(hd);
  return a > b ? a : b;
}

// Bytes of the keep-bit buffer the call needs (keep_bits; 0: none): the
// tensor-core kernels with dropout pass the dq kernel's keep bits on.
FF_EXPORT size_t flash_bwd_workspace_bytes(int dtype, int N, int Sq, int Sk, int H, int hd,
                                           int dropout) {
  if (bwd_tensor_cores(dtype, Sk, hd) && dropout)
    return (size_t)N * H * ((Sq + 15) / 16) * ff::BT_KEEP_GROUP * sizeof(uint32_t);
  return 0;
}

FF_EXPORT int flash_bwd_max_head_dim() { return ff::KV_MAX_HD; }
