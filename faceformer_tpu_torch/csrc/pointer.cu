// K1: pointer argmax, the Hopper counterpart of faceformer_tpu/ops/pointer.py
// (pointer_argmax, pl.pallas_call at pointer.py:48; kernel body :22-30).
//
// What it computes: for every pointer row r of sample n, the fp32 logits
// rows[n, r] . memory[n, s] over all S memory rows, padded rows set to the
// float32 minimum, and the argmax over s (first index on ties). Only the
// int32 winners are written.
//
// What bounds it here: bytes. At the serve shape (N=20, R=216, S=220,
// E=512) it reads ~9 MB in bf16 (2.7 us at 3.35 TB/s) for ~0.97 GFLOP of
// products. bf16 runs pointer.cuh's tensor-core kernel: 140 blocks of 32
// rows at that shape (the card has 132 SMs), each staging its rows once in
// shared memory and streaming its sample's memory through a ring of TMA
// boxes (256 memory rows x 64 columns, swizzled), ldmatrix fragments with
// each A fragment feeding 8 products, mask staged per tile, and the logits
// never leaving registers; the four warps that split a tile's columns merge
// their (max, index) pairs with the first-index rule. fp32 runs a
// CUDA-core kernel that streams memory in 64-row S-tiles with the same
// running (max, index) (the parity path).

#include "pointer.cuh"

FF_EXPORT int pointer_argmax(int dtype, const void* rows, const void* memory, const void* mask,
                             int N, int R, int S, int E, void* out, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto m = static_cast<const uint8_t*>(mask);
  auto o = static_cast<int32_t*>(out);
  if (dtype == FF_FLOAT32)
    return ff::launch_pointer_argmax<float, float>(
        static_cast<const float*>(rows), static_cast<const float*>(memory), m, nullptr, N, R, S,
        E, o, nullptr, st);
  if (dtype == FF_BFLOAT16)
    return ff::launch_pointer_argmax<__nv_bfloat16, __nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(rows), static_cast<const __nv_bfloat16*>(memory), m,
        nullptr, N, R, S, E, o, nullptr, st);
  return (int)cudaErrorInvalidValue;
}

// Test entry, not on any main path: the tensor-core kernel as K4's last
// phase runs it (rows fp32 or bf16, bf16 memory, an optional mask and an
// optional additive fp32 bias, and the gather of the winners into
// `gathered` (N, R, E)).
FF_EXPORT int pointer_argmax_gather(int rows_dtype, const void* rows, const void* memory,
                                    const void* mask, const void* bias, int N, int R, int S,
                                    int E, void* out, void* gathered, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto mem = static_cast<const __nv_bfloat16*>(memory);
  auto m = static_cast<const uint8_t*>(mask);
  auto b = static_cast<const float*>(bias);
  auto o = static_cast<int32_t*>(out);
  auto gth = static_cast<__nv_bfloat16*>(gathered);
  if (rows_dtype == FF_FLOAT32)
    return ff::launch_pointer_argmax<float, __nv_bfloat16>(static_cast<const float*>(rows), mem,
                                                           m, b, N, R, S, E, o, gth, st);
  if (rows_dtype == FF_BFLOAT16)
    return ff::launch_pointer_argmax<__nv_bfloat16, __nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(rows), mem, m, b, N, R, S, E, o, gth, st);
  return (int)cudaErrorInvalidValue;
}
