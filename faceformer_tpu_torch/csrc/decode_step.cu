// K4: one whole greedy step of the anchor-parallel decoder, the Hopper
// counterpart of faceformer_tpu/ops/decode_step.py::decode_step
// (pl.pallas_call at decode_step.py:414; kernel _kernel :119-333).
//
// What it computes, per decoder layer (pre-LN, ReLU): LN1; q/k/v with the
// query position added to the q and k inputs; this step's k/v written into
// the self-attention cache at slot `step`; attention over cached positions
// 0..step; out-projection + residual; LN2; cross-attention against the
// layer's precomputed cross K/V under the memory padding bias (fp32 until
// its residual add); out-projection + residual; LN3; ReLU FFN + residual.
// Then: final LN, pointer projection, fp32 logits against memory + padding
// bias, argmax (first index on ties), and the gather of the winning memory
// row as the next step's input.
//
// What bounds it here: per step ~32 MFLOP of products per anchor row (138
// GFLOP over the 4,320 rows of a 20-sample batch at the `ours` dims; 0.14
// ms on the bf16 tensor cores), plus ~32 MB of weights (L2-resident), ~55
// MB of cross K/V and ~53 MB of cache per cached position, so late steps
// are memory-bound. Design: the one C entry below launches a fixed
// sequence of hand-written kernels on the caller's stream (82 launches per
// step at 6 layers, one device-to-device copy included):
//   - a tensor-core GEMM (mma.sync, cp.async pipeline) with fused epilogues
//     (bias, ReLU, residual add, rounding to the compute type where the
//     Pallas kernel rounds); fp32 operands (the cross-attention output) go
//     through it as three bf16 terms, so they keep fp32 accuracy;
//   - a warp-per-row LayerNorm that also emits `normed + qpos`;
//   - a block-per-row self-attention over the live cache prefix with
//     16-byte loads (it reads the prefix once, near the HBM rate);
//   - the tensor-core attention of attention.cuh for the cross step;
//   - the tensor-core pointer argmax of pointer.cuh with a fused gather.
// The fp32 compute type runs CUDA-core versions of the GEMM and the pointer
// argmax (the parity path). One launch per step is later work.
//
// Cache layout: (L, 2, R, T, E), K then V, each anchor row's positions
// contiguous, so the live prefix of one row is one contiguous read.

#include "attention.cuh"
#include "pointer.cuh"

namespace ff {

// ---------------------------------------------------------------------------
// LayerNorm: one warp per row, fp32 statistics (population variance).
// out_norm = T(LN(x)); out_qk = T(LN(x) + qpos) with LN(x) first rounded to T.
// ---------------------------------------------------------------------------
constexpr int LN_WARPS = 8;

template <typename T>
__global__ void __launch_bounds__(LN_WARPS * 32)
layer_norm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ bias, const T* __restrict__ qpos, int R, int E,
                  T* __restrict__ out_norm, T* __restrict__ out_qk) {
  const int r = blockIdx.x * LN_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= R) return;
  const T* xr = x + (size_t)r * E;
  float sum = 0.f;
  for (int e = lane; e < E; e += 32) sum += to_f(xr[e]);
  const float mean = warp_sum(sum) / E;
  float sq = 0.f;
  for (int e = lane; e < E; e += 32) {
    float d = to_f(xr[e]) - mean;
    sq += d * d;
  }
  const float inv = rsqrtf(warp_sum(sq) / E + 1e-5f);
  for (int e = lane; e < E; e += 32) {
    float y = round_to<T>((to_f(xr[e]) - mean) * inv * scale[e] + bias[e]);
    if (out_norm != nullptr) out_norm[(size_t)r * E + e] = from_f<T>(y);
    if (out_qk != nullptr) out_qk[(size_t)r * E + e] = from_f<T>(y + to_f(qpos[e]));
  }
}

// ---------------------------------------------------------------------------
// GEMM C[M, N] = epilogue(A[M, K] . B[K, N] + bias[N]), fp32 accumulation.
// B is row-major (in, out), the JAX weight layout.
//
// EPI_STORE:    C = TC(acc + bias)
// EPI_RELU:     C = TC(max(acc + bias, 0))
// EPI_RESIDUAL: C = TC(resid + TC(acc + bias)), the add in TC as in
//               `x + (dot + b).astype(dtype)`; C may alias resid.
// ---------------------------------------------------------------------------
enum Epilogue { EPI_STORE = 0, EPI_RELU = 1, EPI_RESIDUAL = 2 };

template <typename TC, int EPI>
__device__ __forceinline__ void epilogue(float acc, int m, int n, const float* bias, TC* C,
                                         int ldc, const TC* resid, int ldr) {
  float y = acc + (bias != nullptr ? bias[n] : 0.f);
  if (EPI == EPI_RELU) y = fmaxf(y, 0.f);
  if (EPI == EPI_RESIDUAL) y = to_f(resid[(size_t)m * ldr + n]) + round_to<TC>(y);
  C[(size_t)m * ldc + n] = from_f<TC>(y);
}

// CUDA-core path (fp32 inputs, and any shape): 64x64 tiles, 16-deep k
// chunks staged in shared memory as fp32, 4x4 outputs per thread.
constexpr int GM = 64, GN = 64, GK = 16, G_THREADS = 256;

template <typename TA, typename TB, typename TC, int EPI>
__global__ void __launch_bounds__(G_THREADS)
gemm_kernel(int M, int N, int K, const TA* __restrict__ A, int lda, const TB* __restrict__ B,
            int ldb, const float* __restrict__ bias, TC* C, int ldc, const TC* resid, int ldr) {
  __shared__ __align__(16) float As[GK][GM + 4];
  __shared__ __align__(16) float Bs[GK][GN + 4];
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int m0 = blockIdx.y * GM, n0 = blockIdx.x * GN;
  float acc[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += GK) {
    for (int idx = tid; idx < GM * GK; idx += G_THREADS) {
      int r = idx / GK, kk = idx % GK;
      int gm = m0 + r, gk = k0 + kk;
      As[kk][r] = (gm < M && gk < K) ? to_f(A[(size_t)gm * lda + gk]) : 0.f;
    }
    for (int idx = tid; idx < GK * GN; idx += G_THREADS) {
      int kk = idx / GN, c = idx % GN;
      int gk = k0 + kk, gn = n0 + c;
      Bs[kk][c] = (gk < K && gn < N) ? to_f(B[(size_t)gk * ldb + gn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GK; ++kk) {
      float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int n = n0 + tx * 4 + j;
      if (n < N) epilogue<TC, EPI>(acc[i][j], m, n, bias, C, ldc, resid, ldr);
    }
  }
}

// Tensor-core path (bf16 B; A bf16, or fp32 as in the cross-attention
// out-projection): mma.sync m16n8k16 with fp32 accumulation. 64x64 block
// tile, 32-deep k tiles in a 3-stage cp.async pipeline, 4 warps each owning
// a 32x32 sub-tile (2 x 4 mma tiles). B stays row-major (k, n) as the
// weights are stored and is read with ldmatrix.trans; bf16 A is read with
// ldmatrix; fp32 A is split into three bf16 terms (split3), three products
// per tile, so that product keeps fp32 accuracy. Row strides of 80 and 144
// bytes keep the 8 rows of each ldmatrix on distinct banks. At M = 4,320
// rows a 64x64 tile gives 4+ blocks per SM; a 128x128 tile (136 blocks on
// 132 SMs) measured slower.
constexpr int TM = 64, TN = 64, TKK = 32, T_STAGES = 3;
constexpr int WTM = 32, WTN = 32, MTS = WTM / 16;  // warp tile, mma tiles along m
constexpr int T_THREADS = (TM / WTM) * (TN / WTN) * 32;
constexpr int AS_STRIDE = TKK + 8, BS_STRIDE = TN + 8;

template <typename TA> constexpr size_t gemm_tc_smem_bytes() {
  return (size_t)T_STAGES * (TM * AS_STRIDE * sizeof(TA) + TKK * BS_STRIDE * 2);
}

template <typename TA, typename TC, int EPI>
__global__ void __launch_bounds__(T_THREADS)
gemm_tc_kernel(int M, int N, int K, const TA* __restrict__ A, int lda,
               const __nv_bfloat16* __restrict__ B, int ldb, const float* __restrict__ bias,
               TC* C, int ldc, const TC* resid, int ldr) {
  using bf16 = __nv_bfloat16;
  constexpr bool F32A = std::is_same<TA, float>::value;
  constexpr int AV = 16 / sizeof(TA), TERMS = F32A ? 3 : 1;
  extern __shared__ __align__(16) unsigned char gsm[];
  auto As = reinterpret_cast<TA(*)[TM][AS_STRIDE]>(gsm);
  auto Bs = reinterpret_cast<bf16(*)[TKK][BS_STRIDE]>(gsm + T_STAGES * TM * AS_STRIDE * sizeof(TA));
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tig = lane & 3, mi = lane / 8, rr = lane % 8;
  const int wm = (warp / (TN / WTN)) * WTM, wn = (warp % (TN / WTN)) * WTN;
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const int ktiles = K / TKK;

  auto load_stage = [&](int stage, int kt) {
    const int k0 = kt * TKK;
    for (int c = tid; c < TM * TKK / AV; c += T_THREADS) {
      const int r = c / (TKK / AV), kc = (c % (TKK / AV)) * AV;
      const bool ok = m0 + r < M;
      cp_async16(&As[stage][r][kc], ok ? A + (size_t)(m0 + r) * lda + k0 + kc : A, ok);
    }
    for (int c = tid; c < TKK * TN / 8; c += T_THREADS) {
      const int kr = c / (TN / 8), nc = (c % (TN / 8)) * 8;
      const bool ok = n0 + nc < N;
      cp_async16(&Bs[stage][kr][nc], ok ? B + (size_t)(k0 + kr) * ldb + n0 + nc : B, ok);
    }
  };

  float acc[MTS][4][4] = {};
#pragma unroll
  for (int st = 0; st < T_STAGES - 1; ++st) {
    if (st < ktiles) load_stage(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<T_STAGES - 2>();  // tile kt has landed
    __syncthreads();                // ... and every warp is done with tile kt - 1
    const int next = kt + T_STAGES - 1;
    if (next < ktiles) load_stage(next % T_STAGES, next);
    cp_async_commit();
    const int st = kt % T_STAGES;
#pragma unroll
    for (int ks = 0; ks < TKK; ks += 16) {
      uint32_t a[MTS][4 * TERMS], b[4][2];
#pragma unroll
      for (int mt = 0; mt < MTS; ++mt) {
        if constexpr (F32A) {
          const int r = wm + mt * 16 + g, k = ks + tig * 2;
          const float2 x[4] = {*reinterpret_cast<const float2*>(&As[st][r][k]),
                               *reinterpret_cast<const float2*>(&As[st][r + 8][k]),
                               *reinterpret_cast<const float2*>(&As[st][r][k + 8]),
                               *reinterpret_cast<const float2*>(&As[st][r + 8][k + 8])};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float h0, m0_, l0, h1, m1_, l1;
            split3(x[i].x, h0, m0_, l0);
            split3(x[i].y, h1, m1_, l1);
            a[mt][i] = pack_bf16(h0, h1);
            a[mt][4 + i] = pack_bf16(m0_, m1_);
            a[mt][8 + i] = pack_bf16(l0, l1);
          }
        } else {
          // A matrices: rows 0-7 / 8-15 (mi & 1) x k 0-7 / 8-15 (mi >> 1)
          ldmatrix_x4(a[mt], &As[st][wm + mt * 16 + (mi & 1) * 8 + rr][ks + (mi >> 1) * 8]);
        }
      }
      // B matrices: k 0-7 / 8-15 (mi & 1) x n-tile 2np / 2np+1 (mi >> 1)
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t r4[4];
        ldmatrix_x4_trans(r4, &Bs[st][ks + (mi & 1) * 8 + rr][wn + (2 * np + (mi >> 1)) * 8]);
        b[2 * np][0] = r4[0];
        b[2 * np][1] = r4[1];
        b[2 * np + 1][0] = r4[2];
        b[2 * np + 1][1] = r4[3];
      }
#pragma unroll
      for (int mt = 0; mt < MTS; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int t = 0; t < TERMS; ++t) mma_bf16_16816(acc[mt][nt], a[mt] + 4 * t, b[nt]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < MTS; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = m0 + wm + mt * 16 + g + (i / 2) * 8;
        const int n = n0 + wn + nt * 8 + tig * 2 + (i % 2);
        if (m < M && n < N) epilogue<TC, EPI>(acc[mt][nt][i], m, n, bias, C, ldc, resid, ldr);
      }
}

template <int EPI, typename TA, typename TB, typename TC>
inline cudaError_t gemm(int M, int N, int K, const TA* A, int lda, const TB* B, int ldb,
                        const float* bias, TC* C, int ldc, const TC* resid, int ldr,
                        cudaStream_t st) {
  if constexpr (std::is_same<TB, __nv_bfloat16>::value) {
    // 16-byte tile loads need K a multiple of the k tile and aligned rows
    const bool aligned = reinterpret_cast<uintptr_t>(A) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(B) % 16 == 0;
    if (K % TKK == 0 && N % 8 == 0 && lda % (16 / sizeof(TA)) == 0 && ldb % 8 == 0 &&
        aligned) {
      constexpr size_t smem = gemm_tc_smem_bytes<TA>();
      auto kernel = gemm_tc_kernel<TA, TC, EPI>;
      const cudaError_t e = allow_smem(kernel, smem);
      if (e != cudaSuccess) return e;
      dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM);
      kernel<<<grid, T_THREADS, smem, st>>>(M, N, K, A, lda, B, ldb, bias, C, ldc, resid, ldr);
      return cudaGetLastError();
    }
  }
  dim3 grid((N + GN - 1) / GN, (M + GM - 1) / GM);
  gemm_kernel<TA, TB, TC, EPI><<<grid, G_THREADS, 0, st>>>(M, N, K, A, lda, B, ldb, bias, C, ldc,
                                                           resid, ldr);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Self-attention over the live cache prefix: one block per anchor row, one
// warp per head. Scores sum_d (q*scale)*k in fp32 over positions 0..step
// (this step's k/v already sit in slot `step`), softmax in fp32, output
// rounded to T. Every load is 16 bytes: LPP = hd / VEC lanes share one
// cached position (a 128-byte head row at hd = 64 in bf16), so one warp
// reads 32 / LPP positions per iteration, coalesced.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void self_attention_kernel(const T* __restrict__ q, const T* __restrict__ ck,
                                      const T* __restrict__ cv, int Tmax, int E, int H, int step,
                                      float scale, T* __restrict__ out) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ float sa_smem[];  // [H][Tmax] scores, then probabilities
  const int r = blockIdx.x, h = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int lpp = E / H / VEC, ppw = 32 / lpp;
  const int u = lane % lpp, pg = lane / lpp;
  float* pw = sa_smem + h * Tmax;
  const size_t col = (size_t)h * (E / H) + u * VEC;
  const T* kr = ck + (size_t)r * Tmax * E + col;
  const T* vr = cv + (size_t)r * Tmax * E + col;

  float qv[VEC];
  {
    const uint4 raw = *reinterpret_cast<const uint4*>(q + (size_t)r * E + col);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) qv[i] = to_f(e[i]) * scale;
  }
  float mx = -INFINITY;
  for (int j0 = 0; j0 <= step; j0 += ppw) {
    const int j = j0 + pg;
    float s = 0.f;
    if (j <= step) {
      const uint4 raw = *reinterpret_cast<const uint4*>(kr + (size_t)j * E);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < VEC; ++i) s = fmaf(qv[i], to_f(e[i]), s);
    }
    for (int off = lpp / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (j <= step) {
      if (u == 0) pw[j] = s;
      mx = fmaxf(mx, s);
    }
  }
  mx = warp_max(mx);
  __syncwarp();
  float sum = 0.f;
  for (int j = lane; j <= step; j += 32) {
    const float e = expf(pw[j] - mx);
    pw[j] = e;
    sum += e;
  }
  const float denom = warp_sum(sum);
  __syncwarp();
  float acc[VEC] = {};
  for (int j = pg; j <= step; j += ppw) {
    const float p = pw[j] / denom;
    const uint4 raw = *reinterpret_cast<const uint4*>(vr + (size_t)j * E);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = fmaf(p, to_f(e[i]), acc[i]);
  }
  for (int off = lpp; off < 32; off <<= 1)
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
  if (pg == 0) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) e[i] = from_f<T>(acc[i]);
    *reinterpret_cast<uint4*>(out + (size_t)r * E + col) = raw;
  }
}

// rows of the packed per-layer vector table (decode_step.py:101-103)
enum Vec { BQ, BK, BV, BO, CBQ, CBO, FB2, N1S, N1B, N2S, N2B, N3S, N3B, NVEC = 16 };

template <typename T>
int decode_step_impl(int step, int N, int F, int S, int E, int FF, int H, int L, int Tmax,
                     const T* x, const T* qpos, const T* w_mats, const float* vecs,
                     const T* ffn_w1, const T* ffn_w2, const float* ffn_b1, const float* fnorm,
                     const T* proj_w, const float* proj_b, const T* cross_k, const T* cross_v,
                     const T* memory, const float* mem_bias, T* cache, T* x_out, int32_t* tok,
                     T* xs, T* xn, T* qk, T* q, T* attn, float* q2, float* cross, T* h1,
                     cudaStream_t st) {
  const int R = N * F, hd = E / H;
  const float scale = 1.0f / sqrtf((float)hd);
  const size_t EE = (size_t)E * E, RTE = (size_t)R * Tmax * E;
  const dim3 ln_grid((R + LN_WARPS - 1) / LN_WARPS);
  const size_t sa_smem = (size_t)H * Tmax * sizeof(float);

  FF_TRY(cudaMemcpyAsync(xs, x, (size_t)R * E * sizeof(T), cudaMemcpyDeviceToDevice, st));
  for (int l = 0; l < L; ++l) {
    const float* vec = vecs + (size_t)l * NVEC * E;
    const T* W = w_mats + (size_t)l * 6 * EE;
    T* kc = cache + (size_t)(2 * l) * RTE;
    T* vc = cache + (size_t)(2 * l + 1) * RTE;

    // self-attention
    layer_norm_kernel<T><<<ln_grid, LN_WARPS * 32, 0, st>>>(xs, vec + N1S * E, vec + N1B * E,
                                                            qpos, R, E, xn, qk);
    FF_TRY(cudaGetLastError());
    FF_TRY(gemm<EPI_STORE>(R, E, E, qk, E, W, E, vec + BQ * E, q, E, (const T*)nullptr, 0, st));
    FF_TRY(gemm<EPI_STORE>(R, E, E, qk, E, W + EE, E, vec + BK * E, kc + (size_t)step * E,
                           Tmax * E, (const T*)nullptr, 0, st));
    FF_TRY(gemm<EPI_STORE>(R, E, E, xn, E, W + 2 * EE, E, vec + BV * E, vc + (size_t)step * E,
                           Tmax * E, (const T*)nullptr, 0, st));
    self_attention_kernel<T><<<R, H * 32, sa_smem, st>>>(q, kc, vc, Tmax, E, H, step, scale,
                                                         attn);
    FF_TRY(cudaGetLastError());
    FF_TRY(gemm<EPI_RESIDUAL>(R, E, E, attn, E, W + 3 * EE, E, vec + BO * E, xs, E,
                              (const T*)xs, E, st));

    // cross-attention, fp32 from the query projection to the residual add
    layer_norm_kernel<T><<<ln_grid, LN_WARPS * 32, 0, st>>>(xs, vec + N2S * E, vec + N2B * E,
                                                            qpos, R, E, nullptr, qk);
    FF_TRY(cudaGetLastError());
    FF_TRY(gemm<EPI_STORE>(R, E, E, qk, E, W + 4 * EE, E, vec + CBQ * E, q2, E,
                           (const float*)nullptr, 0, st));
    FF_TRY((launch_attention<float, T, true>(q2, cross_k + (size_t)l * N * S * E,
                                             cross_v + (size_t)l * N * S * E, mem_bias, cross,
                                             nullptr, N, F, S, H, hd, scale, 0, st)));
    FF_TRY(gemm<EPI_RESIDUAL>(R, E, E, cross, E, W + 5 * EE, E, vec + CBO * E, xs, E,
                              (const T*)xs, E, st));

    // FFN
    layer_norm_kernel<T><<<ln_grid, LN_WARPS * 32, 0, st>>>(xs, vec + N3S * E, vec + N3B * E,
                                                            nullptr, R, E, xn, nullptr);
    FF_TRY(cudaGetLastError());
    FF_TRY(gemm<EPI_RELU>(R, FF, E, xn, E, ffn_w1 + (size_t)l * E * FF, FF,
                          ffn_b1 + (size_t)l * FF, h1, FF, (const T*)nullptr, 0, st));
    FF_TRY(gemm<EPI_RESIDUAL>(R, E, FF, h1, FF, ffn_w2 + (size_t)l * FF * E, E, vec + FB2 * E,
                              xs, E, (const T*)xs, E, st));
  }

  // final norm -> pointer (fp32) -> masked argmax + gather of the next input
  layer_norm_kernel<T><<<ln_grid, LN_WARPS * 32, 0, st>>>(xs, fnorm, fnorm + E, nullptr, R, E,
                                                          xn, nullptr);
  FF_TRY(cudaGetLastError());
  FF_TRY(gemm<EPI_STORE>(R, E, E, xn, E, proj_w, E, proj_b, q2, E, (const float*)nullptr, 0,
                         st));
  FF_TRY((launch_pointer_argmax<float, T>(q2, memory, nullptr, mem_bias, N, F, S, E, tok, x_out,
                                          st)));
  return 0;
}

}  // namespace ff

// Launches per step: 1 copy + 13 per layer + 3 (see PERF.md).
FF_EXPORT int decode_step(int dtype, int step, int N, int F, int S, int E, int FF, int H, int L,
                          int Tmax, const void* x, const void* qpos, const void* w_mats,
                          const void* vecs, const void* ffn_w1, const void* ffn_w2,
                          const void* ffn_b1, const void* fnorm, const void* proj_w,
                          const void* proj_b, const void* cross_k, const void* cross_v,
                          const void* memory, const void* mem_bias, void* cache, void* x_out,
                          void* tok, void* xs, void* xn, void* qk, void* q, void* attn, void* q2,
                          void* cross, void* h1, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
#define FF_DECODE_ARGS(T)                                                                     \
  step, N, F, S, E, FF, H, L, Tmax, static_cast<const T*>(x), static_cast<const T*>(qpos),    \
      static_cast<const T*>(w_mats), static_cast<const float*>(vecs),                         \
      static_cast<const T*>(ffn_w1), static_cast<const T*>(ffn_w2),                           \
      static_cast<const float*>(ffn_b1), static_cast<const float*>(fnorm),                    \
      static_cast<const T*>(proj_w), static_cast<const float*>(proj_b),                       \
      static_cast<const T*>(cross_k), static_cast<const T*>(cross_v),                         \
      static_cast<const T*>(memory), static_cast<const float*>(mem_bias),                     \
      static_cast<T*>(cache), static_cast<T*>(x_out), static_cast<int32_t*>(tok),             \
      static_cast<T*>(xs), static_cast<T*>(xn), static_cast<T*>(qk), static_cast<T*>(q),      \
      static_cast<T*>(attn), static_cast<float*>(q2), static_cast<float*>(cross),             \
      static_cast<T*>(h1), st
  if (dtype == FF_FLOAT32) return ff::decode_step_impl<float>(FF_DECODE_ARGS(float));
  if (dtype == FF_BFLOAT16)
    return ff::decode_step_impl<__nv_bfloat16>(FF_DECODE_ARGS(__nv_bfloat16));
#undef FF_DECODE_ARGS
  return (int)cudaErrorInvalidValue;
}
