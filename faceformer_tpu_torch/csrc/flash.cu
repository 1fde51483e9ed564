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
// What bounds it here: the encoder call (N=20, S=220, H=8, hd=64, bf16)
// moves ~18 MB (5.4 us at 3.35 TB/s) for ~1.6 GFLOP, so it is memory-bound
// in principle. Design: every key side on the serve path has Sk <= 220, so
// one (sequence, head)'s K and V sit in shared memory whole and the softmax
// is exact, not online, as in the Pallas kernel. bf16 at hd = 64 runs the
// tensor-core kernel of attention.cuh (16 query rows per warp with their
// score rows in registers, 64 rows per block); fp32 and other head dims run
// its CUDA-core kernel. Blocks cover the query rows of one (sequence,
// head), which serves both regimes: the long encoder and cross-attention
// query sides split into many blocks, and each of the reference engine's
// short decoder sequences (<= 37 rows) is one block.

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

FF_EXPORT size_t flash_smem_bytes(int dtype, int Sk, int hd) {
  return dtype == FF_FLOAT32 ? ff::attention_smem_bytes<float>(Sk, hd)
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
