// Flash attention backward for NVIDIA Hopper (sm_90a): dQ, dK and dV of
// the function that flash_attention.cu (fp32) and flash_attention_wgmma.cu
// (bf16) compute, from q, k, v, the forward's output o, the output's
// gradient do and the row log-sum-exp (LSE) that those kernels emit.
//
// Replaces no TPU kernel of its own: the reference's training step
// differentiates its jnp attention (src/repro/models/attention.py,
// `attention_chunked`) by autodiff and never calls the Pallas kernel
// `flash_attention_bhsd` (src/repro/kernels/flash_attention/kernel.py:124).
// The port's forward runs the CUDA kernels, so its gradient needs these
// kernels; they compute the gradients that autodiff of the reference's
// attention gives (kernels/flash_attention/ref.py, `attention_bwd_ref`).
// Rows with no live key at all lie outside the contract, as in the
// forward; the autograd Function refuses the calls that have them.
//
// Three entries a dtype, one launch each a call:
//   * flash_bwd_pre_*: D = rowsum(do * o), a warp a row, in fp32 (this
//     file, both dtypes);
//   * flash_bwd_dkdv_*: a block owns one tile of keys of one kv head; it
//     loops over the group's query heads and the query tiles that can reach
//     the tile, recomputes P from q, k and the LSE, and accumulates dV and
//     dK in registers;
//   * flash_bwd_dq_*: a block owns one tile of query rows; it loops over
//     the key tiles in reach and accumulates dQ in registers.
// The passes are flash_attention_bwd_tf32.cu's (fp32: 3xTF32 on the tensor cores,
// cp.async stages) and flash_attention_bwd_wgmma.cu's (bf16: wgmma, TMA).
// No block adds into another's output, so there are no atomics and every
// sum is taken in the same order in every run: the results are
// deterministic, bit for bit.
//
// What bounds D on this card: the bytes (o and do read once, D written).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3, compiled beside
// the other flash sources into one library (kernels/flash_attention/
// _build.py); entry points bound with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// ------------------------------------------------------------ preprocess
constexpr int PRE_THREADS = 256;  // 8 warps, a row each

// delta[row] = sum_d do[row, d] * o[row, d], in fp32, for rows rows of dh;
// a warp a row, its lanes' partial sums added by shuffles in a fixed order
template <typename T>
__global__ void __launch_bounds__(PRE_THREADS)
bwd_pre_kernel(const T* __restrict__ o, const T* __restrict__ d_o, float* __restrict__ delta,
               int rows, int dh) {
  const int row = (int)((blockIdx.x * (unsigned)PRE_THREADS + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // the whole warp: a row is one warp's
  const T* orow = o + (size_t)row * dh;
  const T* drow = d_o + (size_t)row * dh;
  float s = 0.f;
  for (int d = lane; d < dh; d += 32) s += to_f(orow[d]) * to_f(drow[d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[row] = s;
}

// ------------------------------------------------------------------ host
template <typename T>
cudaError_t launch_pre(const void* o, const void* d_o, void* delta, int rows, int dh,
                       cudaStream_t stream) {
  if (rows <= 0) return cudaSuccess;
  const int blocks = (int)(((long long)rows * 32 + PRE_THREADS - 1) / PRE_THREADS);
  bwd_pre_kernel<T><<<blocks, PRE_THREADS, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(d_o), static_cast<float*>(delta), rows, dh);
  return cudaGetLastError();
}

}  // namespace

// delta[r] = sum_d do[r, d] o[r, d] (fp32) for the rows of o and do (rows x
// dh, fp32 or bf16, contiguous). Returns the cudaError_t of the launch.
extern "C" int flash_bwd_pre_f32(const void* o, const void* d_o, void* delta, int rows, int dh,
                                 void* stream) {
  return launch_pre<float>(o, d_o, delta, rows, dh, static_cast<cudaStream_t>(stream));
}

extern "C" int flash_bwd_pre_bf16(const void* o, const void* d_o, void* delta, int rows, int dh,
                                  void* stream) {
  return launch_pre<__nv_bfloat16>(o, d_o, delta, rows, dh, static_cast<cudaStream_t>(stream));
}
