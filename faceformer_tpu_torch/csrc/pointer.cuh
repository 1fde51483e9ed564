// Pointer argmax: fp32 logits rows . memory^T, masked, argmax over memory
// rows with the first index on ties, optionally gathering the winning memory
// row. Shared by pointer.cu (K1: bf16 rows) and the last phase of
// decode_step.cu (K4: fp32 pointer vectors, an additive padding bias and
// the gather of the next step's input). It replaces the body of
// faceformer_tpu/ops/pointer.py::pointer_argmax (:22-30, pallas_call :48)
// and the pointer epilogue of faceformer_tpu/ops/decode_step.py.
//
// What bounds it on the H100: bytes. At the serving shape (N=20, R=216,
// S=220, E=512) a call reads 4.4 MB of bf16 rows (8.8 MB as K4's fp32) and
// 4.5 MB of memory for 0.97 GFLOP of products: 2.7 us at 3.35 TB/s, 1 us on
// the bf16 tensor cores. So the design reads each row once, streams memory
// under the products and keeps every logit in registers; what it cannot
// avoid is one read of a sample's memory per row block, from L2.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace ff {

constexpr int PA_BM = 64;      // pointer rows per block
constexpr int PA_BN = 64;      // memory rows per tile
constexpr int PA_BK = 32;      // embedding chunk
constexpr int PA_THREADS = 256;

// rows (N, R, E) of TR; memory (N, S, E) of TM. Per memory row s the logit
// is sum_e rows*memory in fp32, then mask[s] -> NEG (pointer.py), then
// + bias[s] (decode_step.py's additive padding bias); either may be null.
// out (N, R) int32; gathered (N, R, E), when not null, gets memory[n, out].
// Grid (ceil(R / PA_BM), N). Each thread owns 4 rows x 4 memory rows of a
// 64 x 64 tile; the 16 threads of a row reduce with argmax_merge.
template <typename TR, typename TM>
__global__ void __launch_bounds__(PA_THREADS)
pointer_argmax_kernel(const TR* __restrict__ rows, const TM* __restrict__ memory,
                      const uint8_t* __restrict__ mask, const float* __restrict__ bias,
                      int R, int S, int E, int32_t* __restrict__ out,
                      TM* __restrict__ gathered) {
  __shared__ float As[PA_BM][PA_BK + 1];
  __shared__ float Bs[PA_BN][PA_BK + 1];
  const int n = blockIdx.y;
  const int r0 = blockIdx.x * PA_BM;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const TR* rows_n = rows + (size_t)n * R * E;
  const TM* mem_n = memory + (size_t)n * S * E;

  float best[4];
  int best_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    best[i] = -INFINITY;
    best_i[i] = 0x7fffffff;
  }

  for (int s0 = 0; s0 < S; s0 += PA_BN) {
    float acc[4][4] = {};
    for (int e0 = 0; e0 < E; e0 += PA_BK) {
      __syncthreads();
      for (int idx = tid; idx < PA_BM * PA_BK; idx += PA_THREADS) {
        int r = idx / PA_BK, k = idx % PA_BK;
        int gr = r0 + r, ge = e0 + k;
        As[r][k] = (gr < R && ge < E) ? to_f(rows_n[(size_t)gr * E + ge]) : 0.f;
        int gs = s0 + r;
        Bs[r][k] = (gs < S && ge < E) ? to_f(mem_n[(size_t)gs * E + ge]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < PA_BK; ++k) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[ty + 16 * i][k];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Bs[tx + 16 * j][k];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    // columns reach each thread in increasing order: tiles ascend, j ascends
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int s = s0 + tx + 16 * j;
      if (s >= S) continue;
      bool masked = mask != nullptr && mask[(size_t)n * S + s];
      float add = bias != nullptr ? bias[(size_t)n * S + s] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float v = masked ? NEG : acc[i][j];
        argmax_merge(best[i], best_i[i], v + add, s);
      }
    }
  }

  // the 16 threads sharing a row sit in one half-warp: xor offsets < 16
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float v = best[i];
    int vi = best_i[i];
    for (int o = 8; o > 0; o >>= 1) {
      float v2 = __shfl_xor_sync(0xffffffffu, v, o);
      int i2 = __shfl_xor_sync(0xffffffffu, vi, o);
      argmax_merge(v, vi, v2, i2);
    }
    int r = r0 + ty + 16 * i;
    if (r < R) {
      if (tx == 0) out[(size_t)n * R + r] = vi;
      if (gathered != nullptr) {
        const TM* src = mem_n + (size_t)vi * E;
        TM* dst = gathered + ((size_t)n * R + r) * E;
        for (int e = tx; e < E; e += 16) dst[e] = src[e];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Tensor-core path: bf16 memory; rows bf16, or fp32 split into three bf16
// terms (split3) so the logits keep fp32 accuracy. The same function as
// above with the products on mma.sync m16n8k16.
//
// Grid (ceil(R / RB), N), 8 warps. A block stages its RB pointer rows once
// in shared memory (bf16 by cp.async; fp32 split once into three bf16
// planes) and streams its sample's memory through a ring of two TMA boxes
// of TS memory rows x 64 embedding columns (128 bytes, swizzled), so the
// next box lands under this one's products; for bf16 rows TS = 256 rows
// cover the serving memory (S = 220) in one tile (fp32 rows take 16-row
// blocks and 128-row tiles; see the launcher). One thread issues each box:
// with 16-byte cp.async copies, the issuing warps stalled for about as long
// as the products took. The padding mask and the additive bias of a tile are
// read into registers a tile ahead and staged in shared memory (two
// buffers, by tile parity) before the tile's first products. Warp w owns 16
// pointer rows (w % RG) and one of CS column slices of each tile (w / RG):
// 64 memory rows at RB = 32, so each A fragment feeds 8 products. That
// reuse matters: once the copies are off the warps, ldmatrix reads bound
// the kernel (a warp reads its A fragments again for every tile and slice,
// three times over for fp32 rows). Slices past S are skipped. Each lane
// keeps a running (max, index) for its two rows; the quad merges by
// shuffles and the column slices through shared memory, all with
// argmax_merge, whose result (the largest value, then the lowest index)
// does not depend on the merge order.
// ---------------------------------------------------------------------------
constexpr int PT_WARPS = 8, PT_EC = 64;  // embedding columns a box (128 bytes)
constexpr int PT_ST = 2;                 // boxes in the ring: one landing, one in use

template <int TERMS, int RB, int TS> struct PointerTcSmem {
  static_assert(PT_WARPS * 32 >= TS, "one thread stages each tile row's mask and bias");
  static constexpr int RG = RB / 16, CS = PT_WARPS / RG, CW = TS / CS, NT = CW / 8;
  static_assert(NT % 2 == 0, "B fragments come in pairs of n-tiles");
  static constexpr size_t BOX = (size_t)TS * PT_EC * 2;
  static constexpr size_t RING = PT_ST * BOX;
  __host__ __device__ static size_t rows_bytes(int E) { return (size_t)TERMS * RB * (E + 8) * 2; }
  static constexpr size_t TAGS = (size_t)2 * TS * (sizeof(float) + 1);  // by tile parity
  static constexpr size_t MERGE = (size_t)CS * RB * (sizeof(float) + sizeof(int));
  // + the barriers, + 1 KB to align the ring to the swizzle pattern
  __host__ __device__ static size_t bytes(int E) {
    return RING + rows_bytes(E) + TAGS + MERGE + PT_ST * 8 + 1024;
  }
};

template <typename TR, int RB, int TS>
__global__ void __launch_bounds__(PT_WARPS * 32, 2)  // two blocks an SM at E = 512
pointer_argmax_tc_kernel(const __grid_constant__ CUtensorMap mem_map, const TR* __restrict__ rows,
                         const __nv_bfloat16* __restrict__ memory,
                         const uint8_t* __restrict__ mask, const float* __restrict__ bias, int R,
                         int S, int E, int32_t* __restrict__ out,
                         __nv_bfloat16* __restrict__ gathered) {
  using bf16 = __nv_bfloat16;
  constexpr int TERMS = std::is_same<TR, float>::value ? 3 : 1;
  using L = PointerTcSmem<TERMS, RB, TS>;
  constexpr int RG = L::RG, CS = L::CS, CW = L::CW, NT = L::NT;
  extern __shared__ unsigned char psm_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(psm_raw) + 1023) & ~uintptr_t(1023));  // [PT_ST][TS][128 B]
  const int rstr = E + 8;
  bf16* planes = reinterpret_cast<bf16*>(ring + L::RING);  // [TERMS][RB][E + 8]
  auto tag_bias = reinterpret_cast<float(*)[TS]>(ring + L::RING + L::rows_bytes(E));
  auto tag_mask = reinterpret_cast<uint8_t(*)[TS]>(tag_bias + 2);
  float* m_best = reinterpret_cast<float*>(tag_mask + 2);
  int* m_idx = reinterpret_cast<int*>(m_best + CS * RB);  // [CS][RB] each
  uint64_t* full = reinterpret_cast<uint64_t*>(m_idx + CS * RB);

  const int n = blockIdx.y, r0 = blockIdx.x * RB, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane >> 2, tig = lane & 3;
  const int rg = warp % RG, cs = warp / RG, mi = lane >> 3, rr = lane & 7;
  const bf16* mem_n = memory + (size_t)n * S * E;
  const int chunks = (E + PT_EC - 1) / PT_EC, tiles = (S + TS - 1) / TS;
  const int total = tiles * chunks;

  if (tid == 0) {
    for (int st = 0; st < PT_ST; ++st) mbar_init(&full[st], 1);
    fence_mbar_init();
  }
  __syncthreads();

  // a tile's mask and bias, read into registers a tile ahead of their use
  float next_bias = 0.f;
  uint8_t next_mask = 0;
  if (tid < TS && tid < S) {
    if (bias != nullptr) next_bias = bias[(size_t)n * S + tid];
    if (mask != nullptr) next_mask = mask[(size_t)n * S + tid];
  }
  // ring stage i: memory rows of tile i / chunks, the columns of chunk
  // i % chunks (zeros past S and E)
  auto issue = [&](int i) {
    if (tid == 0) {
      const int slot = i % PT_ST;
      mbar_expect_tx(&full[slot], (uint32_t)L::BOX);
      tma_load_3d(ring + slot * L::BOX, &mem_map, &full[slot], (i % chunks) * PT_EC,
                  (i / chunks) * TS, n);
    }
  };

  // the block's rows, once: cp.async for bf16; fp32 rows are split into
  // hi / mid / lo planes by plain loads, eight 16-byte loads in flight a
  // thread
  const TR* rows_b = rows + ((size_t)n * R + r0) * E;
  if constexpr (TERMS == 1) {
    for (int c = tid; c < RB * E / 8; c += PT_WARPS * 32) {
      const int r = c / (E / 8), e = (c % (E / 8)) * 8;
      const bool ok = r0 + r < R;
      cp_async16(planes + r * rstr + e, ok ? rows_b + (size_t)r * E + e : rows, ok);
    }
    cp_async_commit();
  }
  issue(0);  // the loop below keeps the next box in flight
  if constexpr (TERMS == 3) {
    constexpr int U = 8;
    const size_t plane = (size_t)RB * rstr;
    for (int c0 = tid; c0 < RB * E / 4; c0 += U * PT_WARPS * 32) {
      float4 x[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int c = c0 + u * PT_WARPS * 32, r = c / (E / 4), e = (c % (E / 4)) * 4;
        x[u] = c < RB * E / 4 && r0 + r < R
                   ? *reinterpret_cast<const float4*>(rows_b + (size_t)r * E + e)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int c = c0 + u * PT_WARPS * 32, r = c / (E / 4), e = (c % (E / 4)) * 4;
        if (c >= RB * E / 4) break;
        const float v[4] = {x[u].x, x[u].y, x[u].z, x[u].w};
        float h[4], m[4], l[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) split3(v[q], h[q], m[q], l[q]);
        bf16* dst = planes + r * rstr + e;
        *reinterpret_cast<uint2*>(dst) = make_uint2(pack_bf16(h[0], h[1]), pack_bf16(h[2], h[3]));
        *reinterpret_cast<uint2*>(dst + plane) =
            make_uint2(pack_bf16(m[0], m[1]), pack_bf16(m[2], m[3]));
        *reinterpret_cast<uint2*>(dst + 2 * plane) =
            make_uint2(pack_bf16(l[0], l[1]), pack_bf16(l[2], l[3]));
      }
    }
  } else {
    cp_async_wait<0>();
  }

  float best[2] = {-INFINITY, -INFINITY};
  int best_i[2] = {0x7fffffff, 0x7fffffff};
  float acc[NT][4] = {};
  // A: rows 0-7 / 8-15 (mi & 1) x k 0-7 / 8-15 (mi >> 1) of the warp's 16
  const bf16* a_base = planes + (rg * 16 + (mi & 1) * 8 + rr) * rstr + (mi >> 1) * 8;
#pragma unroll 1
  for (int i = 0; i < total; ++i) {
    const int slot = i % PT_ST, e0 = (i % chunks) * PT_EC, s0 = (i / chunks) * TS;
    const int tp = (i / chunks) & 1;  // the tile's tag buffer
    if (i % chunks == 0) {
      // the tile two back, which used this buffer, was merged before the
      // last barrier; the barrier below publishes these
      if (tid < TS) {
        tag_bias[tp][tid] = next_bias;
        tag_mask[tp][tid] = next_mask;
      }
      const int s = s0 + TS + tid;
      next_bias = 0.f;
      next_mask = 0;
      if (tid < TS && s < S) {
        if (bias != nullptr) next_bias = bias[(size_t)n * S + s];
        if (mask != nullptr) next_mask = mask[(size_t)n * S + s];
      }
    }
    mbar_wait(&full[slot], (i / PT_ST) & 1);  // stage i has landed
    __syncthreads();                       // ... and every warp is done with stage i - 1
    if (i + 1 < total) issue(i + 1);
    // B rows (memory rows) of this warp's slice; in the swizzled box, the
    // 16-byte chunk c of row j lies at chunk c ^ (j % 8), and j % 8 = rr
    const unsigned char* box = ring + slot * L::BOX + (size_t)(cs * CW + rr) * 128;
    const int kend = min(PT_EC, E - e0);
    const int live = S - s0 - cs * CW;  // memory rows of the warp's slice below S
#pragma unroll
    for (int ks = 0; ks < PT_EC; ks += 16) {
      if (ks >= kend || live <= 0) break;
      uint32_t a[TERMS][4];
#pragma unroll
      for (int t = 0; t < TERMS; ++t)
        ldmatrix_x4(a[t], a_base + (size_t)t * RB * rstr + e0 + ks);
      const int chunk = ((ks >> 3) + (mi & 1)) ^ rr;  // k 0-7 / 8-15 (mi & 1)
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        if (np * 16 >= live) break;
        uint32_t b[4];  // memory rows of n-tile 2np / 2np+1 (mi >> 1)
        ldmatrix_x4(b, box + (size_t)(np * 16 + (mi >> 1) * 8) * 128 + (chunk << 4));
#pragma unroll
        for (int t = 0; t < TERMS; ++t) {
          mma_bf16_16816(acc[2 * np], a[t], b);
          mma_bf16_16816(acc[2 * np + 1], a[t], b + 2);
        }
      }
    }
    if (i % chunks == chunks - 1) {  // the tile's logits are complete
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = cs * CW + nt * 8 + tig * 2 + (q & 1);
          if (s0 + j < S) {
            const float v = (tag_mask[tp][j] ? NEG : acc[nt][q]) + tag_bias[tp][j];
            argmax_merge(best[q / 2], best_i[q / 2], v, s0 + j);
          }
          acc[nt][q] = 0.f;
        }
    }
  }

  // the quad, then the column slices (fixed order), then out and the gather
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    for (int off = 1; off < 4; off <<= 1) {
      const float v2 = __shfl_xor_sync(0xffffffffu, best[h], off);
      const int i2 = __shfl_xor_sync(0xffffffffu, best_i[h], off);
      argmax_merge(best[h], best_i[h], v2, i2);
    }
    if (tig == 0) {
      m_best[cs * RB + rg * 16 + g + 8 * h] = best[h];
      m_idx[cs * RB + rg * 16 + g + 8 * h] = best_i[h];
    }
  }
  __syncthreads();
  if (tid < RB) {
    float v = m_best[tid];
    int vi = m_idx[tid];
    for (int c = 1; c < CS; ++c) argmax_merge(v, vi, m_best[c * RB + tid], m_idx[c * RB + tid]);
    m_idx[tid] = vi;
    if (r0 + tid < R) out[(size_t)n * R + r0 + tid] = vi;
  }
  if (gathered == nullptr) return;
  __syncthreads();
  for (int c = tid; c < RB * E / 8; c += PT_WARPS * 32) {
    const int r = c / (E / 8), e = (c % (E / 8)) * 8;
    if (r0 + r >= R) continue;
    const bf16* src = mem_n + (size_t)min(m_idx[r], S - 1) * E + e;
    *reinterpret_cast<uint4*>(gathered + ((size_t)n * R + r0 + r) * E + e) =
        *reinterpret_cast<const uint4*>(src);
  }
}

template <typename TR, int RB, int TS>
inline cudaError_t launch_pointer_tc(const TR* rows, const __nv_bfloat16* memory,
                                     const uint8_t* mask, const float* bias, int N, int R, int S,
                                     int E, int32_t* out, __nv_bfloat16* gathered,
                                     cudaStream_t stream) {
  constexpr int TERMS = std::is_same<TR, float>::value ? 3 : 1;
  CUtensorMap map;  // memory (N, S, E) in boxes of (1, TS, 64)
  if (!tma_map<__nv_bfloat16, 3>(&map, memory, {(uint64_t)E, (uint64_t)S, (uint64_t)N},
                                 {(uint64_t)E, (uint64_t)S * E}, {PT_EC, TS, 1}))
    return cudaErrorNotSupported;
  const size_t smem = PointerTcSmem<TERMS, RB, TS>::bytes(E);
  auto kernel = pointer_argmax_tc_kernel<TR, RB, TS>;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((R + RB - 1) / RB, N);
  kernel<<<grid, PT_WARPS * 32, smem, stream>>>(map, rows, memory, mask, bias, R, S, E, out,
                                                gathered);
  return cudaGetLastError();
}

// The tensor-core path for bf16 memory: bf16 rows in 32-row blocks with
// 256-row tiles (140 blocks at the serving shape, two an SM), fp32 rows in
// 16-row blocks with 128-row tiles (280 blocks; their three planes leave
// room for one 32-row block an SM, which measured slower); 16-row blocks
// also for bf16 rows past E = 2,512. Shared memory then takes E up to
// 6,112 (bf16) and 2,032 (fp32). Else the CUDA-core kernel above.
template <typename TR, typename TM>
inline cudaError_t launch_pointer_argmax(const TR* rows, const TM* memory, const uint8_t* mask,
                                         const float* bias, int N, int R, int S, int E,
                                         int32_t* out, TM* gathered, cudaStream_t stream) {
  if constexpr (std::is_same<TM, __nv_bfloat16>::value) {
    constexpr bool F32R = std::is_same<TR, float>::value;
    constexpr size_t SMEM_MAX = 232448;  // a block's limit on sm_90
    const bool aligned = reinterpret_cast<uintptr_t>(rows) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(memory) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(gathered) % 16 == 0;
    if (E % 16 == 0 && aligned) {
      if constexpr (!F32R)
        if (PointerTcSmem<1, 32, 256>::bytes(E) <= SMEM_MAX)
          return launch_pointer_tc<TR, 32, 256>(rows, memory, mask, bias, N, R, S, E, out,
                                                gathered, stream);
      if (PointerTcSmem<F32R ? 3 : 1, 16, 128>::bytes(E) <= SMEM_MAX)
        return launch_pointer_tc<TR, 16, 128>(rows, memory, mask, bias, N, R, S, E, out,
                                              gathered, stream);
    }
  }
  dim3 grid((R + PA_BM - 1) / PA_BM, N);
  pointer_argmax_kernel<TR, TM><<<grid, PA_THREADS, 0, stream>>>(rows, memory, mask, bias, R, S,
                                                                 E, out, gathered);
  return cudaGetLastError();
}

}  // namespace ff
