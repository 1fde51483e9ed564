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
// Design: every key side on the main paths has Sk <= 220, so one
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

#include "attention.cuh"

template <bool DROP>
static int flash_fwd_impl(int dtype, const void* q, const void* k, const void* v, const float* b,
                          int N, int Sq, int Sk, int H, int hd, float scale, int causal,
                          ff::Dropout drop, void* out, float* l, cudaStream_t st) {
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
                        float drop_scale, void* out, void* lse, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto b = static_cast<const float*>(bias);
  auto l = static_cast<float*>(lse);
  const ff::Dropout drop = ff::make_dropout(seed, threshold, drop_scale);
  if (drop.on())
    return flash_fwd_impl<true>(dtype, q, k, v, b, N, Sq, Sk, H, hd, scale, causal, drop, out,
                                l, st);
  return flash_fwd_impl<false>(dtype, q, k, v, b, N, Sq, Sk, H, hd, scale, causal, drop, out, l,
                               st);
}

// The dynamic shared memory of the kernel that takes (dtype, Sk, hd): the
// tensor-core kernel's larger walk, or the CUDA-core kernel's.
FF_EXPORT size_t flash_smem_bytes(int dtype, int Sk, int hd) {
  if (dtype == FF_FLOAT32) return ff::attention_smem_bytes<float>(Sk, hd);
  return ff::takes_tc(Sk, hd) ? ff::tc_smem_for<__nv_bfloat16>(Sk)
                              : ff::attention_smem_bytes<__nv_bfloat16>(Sk, hd);
}

// The keep mask alone, as bytes (N, H, Sq, Sk): what both flash kernels apply
// for this seed, for holding it against ops/flash.py::philox_keep_mask.
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

FF_EXPORT int flash_keep_mask(unsigned long long seed, unsigned int threshold, int N, int H,
                              int Sq, int Sk, void* out, void* stream) {
  const size_t total = (size_t)N * H * Sq * Sk;
  const int blocks = (int)((total + 255) / 256 < 65535 * 16 ? (total + 255) / 256 : 65535 * 16);
  keep_mask_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      ff::make_dropout(seed, threshold, 1.f), H, Sq, Sk, static_cast<unsigned char*>(out), total);
  return (int)cudaGetLastError();
}
