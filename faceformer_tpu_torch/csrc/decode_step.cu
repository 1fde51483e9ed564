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
// What bounds it here: per step ~32 MFLOP of products per anchor row: 49
// products (q, k, v, out, cross q, cross out, FFN in and out in each of 6
// layers, then the pointer projection), 138.2 GFLOP over the 4,320 rows of
// a 20-sample batch at the `ours` dims, 0.140 ms on the bf16 tensor cores at
// 989 TFLOP/s; plus ~32 MB of weights (L2-resident), ~55 MB of cross K/V
// and ~53 MB of cache per cached position, so late steps are memory-bound.
// Design: the one C entry below launches a fixed sequence of hand-written
// kernels on the caller's stream (82 launches per step at 6 layers, one
// device-to-device copy included):
//   - a Hopper GEMM: wgmma with fp32 accumulators, 192 x 128 block tiles
//     fed by TMA through a 4-stage mbarrier ring from one producer warp to
//     three consumer warpgroups, fused epilogues (bias, ReLU, residual add,
//     rounding to the compute type where the Pallas kernel rounds) stored
//     by TMA; the fp32 cross-attention output enters it as three bf16 terms
//     from registers, so that product keeps fp32 accuracy;
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
#include "hopper.cuh"
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

// ---------------------------------------------------------------------------
// Hopper GEMM (bf16 B; A bf16, or fp32 as the cross-attention output):
// wgmma.mma_async, fp32 accumulators in registers, tiles fed by TMA.
//
// Block tile 192 x 128 x 64: three consumer warpgroups of 64 rows each run
// m64n128k16 wgmma on the tiles a producer warp keeps in flight through a
// ring of 4 stages (3 for fp32 A), one TMA copy per 128-byte-wide box with
// mbarrier completion. Why 192 x 128: at M = 4,320 and N = 512 it makes 92
// blocks, one wave on 132 SMs (a 128 x 128 tile makes 136 blocks, two waves
// with the second almost empty, and re-reads A and B ~20 % more from L2);
// at N = 1,024 it makes 184, two waves, as a 128 x 128 tile would. The
// last row block of 4,320 is half empty.
//
// Shared-memory layouts are TMA's 128-byte swizzle, which the descriptors
// of wgmma name (layout B128): A is K-major, boxes of 64 bf16 (or 32 fp32)
// k-columns by 192 rows; B, stored (in, out) row-major as the weights are,
// is MN-major, boxes of 64 n-columns by 64 k-rows, read with wgmma's
// transpose bit. fp32 A (one product a layer) is read from its swizzled
// tile into registers, split into three bf16 terms (split3) and run as
// three register-A wgmma, so that product keeps fp32 accuracy. The output
// leaves by TMA too: each warpgroup writes its finished tile into its own
// A regions of the ring and one thread stores it (per-thread stores of
// the accumulator pairs took longer than the products). Tails in M, N and
// K are zero-filled by the loads and clipped by the store. The tensor maps
// are encoded on the host by cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint (no link against libcuda).
// ---------------------------------------------------------------------------
constexpr int WG_BM = 192, WG_BN = 128, WG_BK = 64;
constexpr int WG_CONSUMERS = WG_BM / 64;             // warpgroups of 64 rows
constexpr int WG_THREADS = WG_CONSUMERS * 128 + 32;  // + the producer warp
// B's descriptor (MN-major, 128-byte swizzle): the leading byte offset steps
// from one 64-column box to the next, the stride byte offset from one group
// of 8 k-rows to the next. (Swapped, the products come out wrong.)
constexpr uint32_t WG_B_LBO = WG_BK * 128, WG_B_SBO = 1024;

template <typename TA> struct WgmmaTile {
  static constexpr int STAGES = std::is_same<TA, float>::value ? 3 : 4;
  static constexpr int A_BYTES = WG_BM * WG_BK * (int)sizeof(TA);
  static constexpr int B_BYTES = WG_BK * WG_BN * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  // + 1 KB to align the ring to the swizzle's 1,024-byte pattern, + barriers
  static constexpr size_t SMEM = (size_t)STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8;
};

// wgmma shared-memory descriptor, 128-byte swizzle (layout type 1)
__device__ __forceinline__ uint64_t gmma_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int PENDING> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING) : "memory");
}
// keeps the compiler from moving accumulator reads or writes across the
// asynchronous products
__device__ __forceinline__ void acc_fence(float* d) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, fp32) += A (64 x 16, K-major in shared memory) . B (16 x 128,
// MN-major in shared memory)
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}
// the same with A (64 x 16) from registers, in mma.sync's A-fragment layout
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <typename TA, typename TC, int EPI>
__global__ void __launch_bounds__(WG_THREADS, 1)
gemm_wgmma_kernel(const __grid_constant__ CUtensorMap tma_a,
                  const __grid_constant__ CUtensorMap tma_b,
                  const __grid_constant__ CUtensorMap tma_c, int M, int N, int K,
                  const float* __restrict__ bias, const TC* resid, int ldr) {
  using Tile = WgmmaTile<TA>;
  constexpr int STAGES = Tile::STAGES;
  constexpr bool F32A = std::is_same<TA, float>::value;
  extern __shared__ unsigned char wsm_raw[];
  unsigned char* wsm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(wsm_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(wsm + STAGES * Tile::STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.y * WG_BM, n0 = blockIdx.x * WG_BN;
  const int ktiles = (K + WG_BK - 1) / WG_BK;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WG_CONSUMERS * 4);  // one arrival per consumer warp
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (warp == WG_CONSUMERS * 4) {  // the producer warp: one lane issues every copy
    if (lane == 0) {
      for (int kt = 0; kt < ktiles; ++kt) {
        const int s = kt % STAGES, k0 = kt * WG_BK;
        mbar_wait(&empty[s], ((kt / STAGES) & 1) ^ 1);  // a fresh slot passes at once
        mbar_expect_tx(&full[s], Tile::STAGE_BYTES);
        unsigned char* a_dst = wsm + s * Tile::STAGE_BYTES;
        unsigned char* b_dst = a_dst + Tile::A_BYTES;
        tma_load_2d(a_dst, &tma_a, &full[s], k0, m0);
        if (F32A) tma_load_2d(a_dst + WG_BM * 128, &tma_a, &full[s], k0 + 32, m0);
        tma_load_2d(b_dst, &tma_b, &full[s], n0, k0);
        tma_load_2d(b_dst + WG_BK * 128, &tma_b, &full[s], n0 + 64, k0);
      }
    }
    return;
  }

  const int wg = warp / 4, wl = warp % 4, g = lane >> 2, tig = lane & 3;
  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  // Every consumer warpgroup runs its products, also one whose rows all lie
  // past M (zeros from TMA): a branch around wgmma makes ptxas serialize it.
  for (int kt = 0; kt < ktiles; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(&full[s], (kt / STAGES) & 1);
    const unsigned char* a_tile = wsm + s * Tile::STAGE_BYTES;
    const unsigned char* b_tile = a_tile + Tile::A_BYTES;
    if constexpr (!F32A) {
      acc_fence(d);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < WG_BK / 16; ++ks)
        wgmma_ss(d, gmma_desc(a_tile + wg * 64 * 128 + ks * 32, 16, 1024),
                 gmma_desc(b_tile + ks * 16 * 128, WG_B_LBO, WG_B_SBO));
      wgmma_commit();
      wgmma_wait<1>();  // the products of stage kt - 1 are done
      acc_fence(d);
      if (kt > 0 && lane == 0) mbar_arrive(&empty[(kt - 1) % STAGES]);
    } else {
      // A fragments of the warp's 16 rows from the swizzled fp32 tile (16-byte
      // chunk c of row r sits at chunk c ^ (r % 8)), split into three bf16
      // terms, one k16 step at a time into two alternating register sets: a
      // set is rewritten only after the products that read it are done
      const int r = wg * 64 + wl * 16 + g;
      uint32_t a[2][12];
#pragma unroll
      for (int ks = 0; ks < WG_BK / 16; ++ks) {
        const unsigned char* half = a_tile + (ks / 2) * WG_BM * 128;
        const int k = (ks % 2) * 16 + tig * 2;
        auto at = [&](int row, int col) {
          return *reinterpret_cast<const float2*>(half + row * 128 +
                                                  (((col >> 2) ^ (row & 7)) << 4) +
                                                  (col & 3) * 4);
        };
        const float2 x[4] = {at(r, k), at(r + 8, k), at(r, k + 8), at(r + 8, k + 8)};
        wgmma_wait<1>();  // the step that last read a[ks % 2] is done
        split3_fragment(x, 1.f, a[ks % 2]);
        acc_fence(d);
        wgmma_fence();
        const uint64_t db = gmma_desc(b_tile + ks * 16 * 128, WG_B_LBO, WG_B_SBO);
#pragma unroll
        for (int t = 0; t < 3; ++t) wgmma_rs(d, a[ks % 2] + 4 * t, db);
        wgmma_commit();
      }
      wgmma_wait<0>();  // this stage's products are done
      acc_fence(d);
      if (lane == 0) mbar_arrive(&empty[s]);
    }
  }
  wgmma_wait<0>();
  acc_fence(d);

  // Epilogue: the warpgroup writes its 64 x 128 tile, bias, ReLU and the
  // residual add applied, into its own A regions of the ring (free now: all
  // copies have landed and its products are done) as boxes of 128-byte rows
  // in the swizzled layout, and one thread stores them by TMA; rows and
  // columns past M and N are clipped by the store.
  constexpr int BOX_COLS = 128 / (int)sizeof(TC), BOXES = WG_BN / BOX_COLS;
  auto out_box = [&](int b) {  // bf16 A: slot b; fp32 A: slot b / 2, half b % 2
    return F32A ? wsm + (b / 2) * Tile::STAGE_BYTES + (b % 2) * WG_BM * 128 + wg * 64 * 128
                : wsm + b * Tile::STAGE_BYTES + wg * 64 * 128;
  };
  static_assert(BOXES <= (F32A ? 2 * STAGES : STAGES), "the output tile fits in the A regions");
#pragma unroll
  for (int j = 0; j < WG_BN / 8; ++j) {
    const int c = j * 8 + tig * 2, n = n0 + c;  // column pair (c, c + 1) of the tile
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wl * 16 + g + h * 8, m = m0 + wg * 64 + r;
      float y0 = d[4 * j + 2 * h], y1 = d[4 * j + 2 * h + 1];
      if (bias != nullptr && n < N) {
        y0 += bias[n];
        y1 += bias[n + 1];
      }
      if (EPI == EPI_RELU) {
        y0 = fmaxf(y0, 0.f);
        y1 = fmaxf(y1, 0.f);
      }
      if (EPI == EPI_RESIDUAL && m < M && n < N) {  // resid + y rounded to TC, in TC
        const TC* rp = resid + (size_t)m * ldr + n;
        y0 = to_f(rp[0]) + round_to<TC>(y0);
        y1 = to_f(rp[1]) + round_to<TC>(y1);
      }
      const int cb = c % BOX_COLS, byte = cb * (int)sizeof(TC);
      unsigned char* p = out_box(c / BOX_COLS) + r * 128 + (((byte >> 4) ^ (r & 7)) << 4) +
                         (byte & 15);
      if constexpr (std::is_same<TC, float>::value)
        *reinterpret_cast<float2*>(p) = make_float2(y0, y1);
      else
        *reinterpret_cast<uint32_t*>(p) = pack_bf16(y0, y1);
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // writes -> TMA
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");     // the warpgroup's
  if (wl == 0 && lane == 0) {
#pragma unroll
    for (int b = 0; b < BOXES; ++b)
      tma_store_2d(&tma_c, out_box(b), n0 + b * BOX_COLS, m0 + wg * 64);
    tma_store_commit_and_wait();
  }
}

template <typename TA, typename TC, int EPI>
inline cudaError_t gemm_wgmma(int M, int N, int K, const TA* A, int lda,
                              const __nv_bfloat16* B, int ldb, const float* bias, TC* C, int ldc,
                              const TC* resid, int ldr, cudaStream_t st) {
  CUtensorMap map_a, map_b, map_c;
  if (!tma_map<TA, 2>(&map_a, A, {(uint64_t)K, (uint64_t)M}, {(uint64_t)lda},
                      {128 / (uint32_t)sizeof(TA), WG_BM}) ||
      !tma_map<__nv_bfloat16, 2>(&map_b, B, {(uint64_t)N, (uint64_t)K}, {(uint64_t)ldb},
                                 {64, WG_BK}) ||
      !tma_map<TC, 2>(&map_c, C, {(uint64_t)N, (uint64_t)M}, {(uint64_t)ldc},
                      {128 / (uint32_t)sizeof(TC), 64}))
    return cudaErrorNotSupported;
  constexpr size_t smem = WgmmaTile<TA>::SMEM;
  auto kernel = gemm_wgmma_kernel<TA, TC, EPI>;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((N + WG_BN - 1) / WG_BN, (M + WG_BM - 1) / WG_BM);
  kernel<<<grid, WG_THREADS, smem, st>>>(map_a, map_b, map_c, M, N, K, bias, resid, ldr);
  return cudaGetLastError();
}

template <int EPI, typename TA, typename TB, typename TC>
inline cudaError_t gemm(int M, int N, int K, const TA* A, int lda, const TB* B, int ldb,
                        const float* bias, TC* C, int ldc, const TC* resid, int ldr,
                        cudaStream_t st) {
  if constexpr (std::is_same<TB, __nv_bfloat16>::value) {
    // TMA needs 16-byte aligned bases and row strides; the residual is read
    // in column pairs
    auto at = [](const void* p, size_t a) { return reinterpret_cast<uintptr_t>(p) % a == 0; };
    if (N % 8 == 0 && (lda * sizeof(TA)) % 16 == 0 && ldb % 8 == 0 &&
        (ldc * sizeof(TC)) % 16 == 0 && at(A, 16) && at(B, 16) && at(C, 16) &&
        (resid == nullptr || (ldr % 2 == 0 && at(resid, 2 * sizeof(TC)))))
      return gemm_wgmma<TA, TC, EPI>(M, N, K, A, lda, B, ldb, bias, C, ldc, resid, ldr, st);
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

// Test entry, not on the step's path: one product of the step alone, C =
// epilogue(A . B + bias) through the same dispatch as decode_step_impl, so
// each epilogue can be held against a reference at any M. Only the step's
// own combinations (no other kernel is compiled for it): B bf16 with A bf16
// and C bf16 (any epilogue) or fp32 (EPI_STORE), or with A fp32 and C bf16
// (EPI_RESIDUAL); or everything fp32 (any epilogue).
namespace ff {
template <int EPI, typename TA, typename TB, typename TC>
int gemm_test(int M, int N, int K, const void* A, int lda, const void* B, int ldb,
              const void* bias, void* C, int ldc, const void* resid, int ldr, cudaStream_t st) {
  return gemm<EPI>(M, N, K, static_cast<const TA*>(A), lda, static_cast<const TB*>(B), ldb,
                   static_cast<const float*>(bias), static_cast<TC*>(C), ldc,
                   static_cast<const TC*>(resid), ldr, st);
}
template <typename TA, typename TB, typename TC>
int gemm_test_any(int epi, int M, int N, int K, const void* A, int lda, const void* B, int ldb,
                  const void* bias, void* C, int ldc, const void* resid, int ldr,
                  cudaStream_t st) {
  if (epi == EPI_STORE)
    return gemm_test<EPI_STORE, TA, TB, TC>(M, N, K, A, lda, B, ldb, bias, C, ldc, resid, ldr, st);
  if (epi == EPI_RELU)
    return gemm_test<EPI_RELU, TA, TB, TC>(M, N, K, A, lda, B, ldb, bias, C, ldc, resid, ldr, st);
  return gemm_test<EPI_RESIDUAL, TA, TB, TC>(M, N, K, A, lda, B, ldb, bias, C, ldc, resid, ldr,
                                             st);
}
}  // namespace ff

FF_EXPORT int decode_gemm(int a_dtype, int b_dtype, int c_dtype, int epi, int M, int N, int K,
                          const void* A, int lda, const void* B, int ldb, const void* bias,
                          void* C, int ldc, const void* resid, int ldr, void* stream) {
  using bf16 = __nv_bfloat16;
  auto st = static_cast<cudaStream_t>(stream);
  const bool f32a = a_dtype == FF_FLOAT32, bf16a = a_dtype == FF_BFLOAT16;
  const bool f32b = b_dtype == FF_FLOAT32, bf16b = b_dtype == FF_BFLOAT16;
  const bool f32c = c_dtype == FF_FLOAT32, bf16c = c_dtype == FF_BFLOAT16;
  if (epi < ff::EPI_STORE || epi > ff::EPI_RESIDUAL) return (int)cudaErrorInvalidValue;
  if (f32a && f32b && f32c)
    return ff::gemm_test_any<float, float, float>(epi, M, N, K, A, lda, B, ldb, bias, C, ldc,
                                                  resid, ldr, st);
  if (bf16a && bf16b && bf16c)
    return ff::gemm_test_any<bf16, bf16, bf16>(epi, M, N, K, A, lda, B, ldb, bias, C, ldc, resid,
                                               ldr, st);
  if (bf16a && bf16b && f32c && epi == ff::EPI_STORE)
    return ff::gemm_test<ff::EPI_STORE, bf16, bf16, float>(M, N, K, A, lda, B, ldb, bias, C, ldc,
                                                           resid, ldr, st);
  if (f32a && bf16b && bf16c && epi == ff::EPI_RESIDUAL)
    return ff::gemm_test<ff::EPI_RESIDUAL, float, bf16, bf16>(M, N, K, A, lda, B, ldb, bias, C,
                                                              ldc, resid, ldr, st);
  return (int)cudaErrorInvalidValue;
}
