// Flash attention forward for NVIDIA Hopper (sm_90a) on the CUDA cores, for
// fp32 q/k/v: GQA, causal and sliding-window masks, online softmax,
// skipping of fully masked kv tiles. bf16 inputs go to the tensor-core
// kernel of flash_attention_wgmma.cu instead (see kernel.py).
//
// Replaces, for fp32 inputs, the TPU kernel `flash_attention_bhsd` (body
// `_flash_kernel`) of src/repro/kernels/flash_attention/kernel.py and
// computes exactly its function:
//   * q (BHq, Sq, Dh), k/v (BHkv, Sk, Dh), fp32, contiguous; query
//     head h reads kv head h / (BHq / BHkv);
//   * s = q.k * scale (scale = 1/sqrt(Dh), passed in), masked where
//     k_pos > q_pos (causal) or k_pos <= q_pos - window, positions from 0
//     for q and k alike, with the FINITE mask value -1e30;
//   * online softmax in fp32 (m, l, acc), o = acc / max(l, 1e-30);
//   * kv tiles entirely in the future or behind the window are skipped, not
//     masked.
// Ragged lengths (Sq, Sk not multiples of the tile) are masked inside: key
// slots past Sk score -inf (weight exactly 0, and m never falls below its
// finite start), their K/V are staged as 0, and rows past Sq are not
// written. The finite -1e30 matters with a window: a row's first live tile
// can be fully masked for that row; its weights then sum garbage into (l,
// acc) with m = -1e30, and the first real key's correction exp(-1e30 - m)
// is exactly 0, as in the reference. With -inf, exp(-inf - -inf) is NaN.
//
// What bounds it on this card: attention does ~Dh/4 FLOP per byte of fp32
// q/k/v/o, above the H100's ridge, so the bound is the operations: 4*Dh
// FLOP per live (q, k) pair. The reference's fp32 tolerance of 5e-5 rules
// out the tensor cores (TF32 keeps 10 mantissa bits), so this kernel
// computes with fp32 FMAs on the CUDA cores (67 TFLOP/s peak) and keeps
// them fed: each block owns 64 query rows
// and walks the live kv tiles of 64 keys; K/V tiles (and the q tile, once)
// are staged in shared memory as fp32, transposed so that each thread's
// 4x4 score tile takes one 16-byte load of q and one of k per 16 FMAs, and
// its 4 x Dh/16 output tile takes one 16-byte load of P per 4 keys and row
// plus one load of V per key and 4 FMAs.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC, with flash_attention_wgmma.cu, into one library
// (kernels/flash_attention/_build.py); entry point flash_fwd_f32, bound
// with ctypes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per kv tile
constexpr int THREADS = 256;  // a 16 x 16 grid: ty -> 4 rows, tx -> 4 keys / Dh/16 dims
constexpr float MASKED = -1e30f;
static_assert(BQ == 64 && BK == 64, "the staging helpers move 64-row tiles");

// Stage a (64, DH) tile of rows [r0, r0 + 64) of `src` (n rows of DH) into
// shared memory, transposed: dst[d * 64 + r]. Rows past n are 0. Each
// thread moves one 16-byte vector of one row; consecutive threads take
// consecutive rows, so the transposed stores fall in distinct banks.
template <int DH>
__device__ __forceinline__ void stage_transposed(float* dst, const float* src, int r0, int n) {
  constexpr int NV = DH / 4;
  for (int i = threadIdx.x; i < 64 * NV; i += THREADS) {
    const int r = i % 64, d = (i / 64) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n) x = *reinterpret_cast<const float4*>(src + (size_t)(r0 + r) * DH + d);
    dst[(d + 0) * 64 + r] = x.x;
    dst[(d + 1) * 64 + r] = x.y;
    dst[(d + 2) * 64 + r] = x.z;
    dst[(d + 3) * 64 + r] = x.w;
  }
}

// Stage rows [r0, r0 + 64) of `src`, row-major: dst[r * DH + d].
template <int DH>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int r0, int n) {
  constexpr int NV = DH / 4;
  for (int i = threadIdx.x; i < 64 * NV; i += THREADS) {
    const int r = i / NV, d = (i % NV) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n) x = *reinterpret_cast<const float4*>(src + (size_t)(r0 + r) * DH + d);
    *reinterpret_cast<float4*>(dst + r * DH + d) = x;
  }
}

__device__ __forceinline__ float reduce16_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float reduce16_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// grid (ceil(Sq / 64), BHq), THREADS threads, smem_bytes<DH>() dynamic
// shared memory. DPT = Dh / 16 output dims per thread.
template <int DPT>
__global__ void __launch_bounds__(THREADS, 2)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int sq, int sk, int group,
                 int causal, int window, float scale) {
  constexpr int DH = 16 * DPT;
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);  // [DH][BQ]  q tile, transposed
  float* kt = qt + DH * BQ;                     // [DH][BK]  k tile, transposed
  float* vs = kt + DH * BK;                     // [BK][DH]  v tile
  float* ps = vs + BK * DH;                     // [BQ][BK]  softmax weights

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int n_q = (sq + BQ - 1) / BQ;
  const int q0 = (n_q - 1 - (int)blockIdx.x) * BQ;  // longest rows launch first
  const int bh = blockIdx.y;
  const float* qh = q + (size_t)bh * sq * DH;
  const float* kh = k + (size_t)(bh / group) * sk * DH;
  const float* vh = v + (size_t)(bh / group) * sk * DH;

  // the live kv tiles: none entirely in the future, none entirely behind
  // the window, for any row of this block
  const int q_last = min(q0 + BQ, sq) - 1;
  int t_begin = 0, t_end = (sk + BK - 1) / BK;
  if (causal) t_end = min(t_end, q_last / BK + 1);
  if (window > 0 && q0 - window + 1 > 0) t_begin = (q0 - window + 1) / BK;

  stage_transposed<DH>(qt, qh, q0, sq);

  float m_i[4], l_i[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = MASKED;
    l_i[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DPT; ++e) acc[i][e] = 0.f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's readers are done
    stage_transposed<DH>(kt, kh, k0, sk);
    stage_rows<DH>(vs, vh, k0, sk);
    __syncthreads();

    // scores of rows 4ty + i against keys 4tx + j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&qt[d * BQ + 4 * ty]);
      const float4 b = *reinterpret_cast<const float4*>(&kt[d * BK + 4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

    // masks, then the online-softmax update; a row's 64 keys live in the
    // 16 lanes that share its ty, so the row reductions are shuffles
    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      float mx = MASKED;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + 4 * tx + j;
        float x = s[i][j] * scale;
        if (col >= sk) {
          x = -INFINITY;  // ragged tail: no key here
        } else if ((causal && col > row) || (window > 0 && col <= row - window)) {
          x = MASKED;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m_i[i], reduce16_max(mx));
      corr[i] = expf(m_i[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
      l_i[i] = l_i[i] * corr[i] + reduce16_sum(rs);
      m_i[i] = m_new;
      *reinterpret_cast<float4*>(&ps[(4 * ty + i) * BK + 4 * tx]) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    }
    __syncthreads();

    // acc = acc * corr + P V for rows 4ty + i, dims tx + 16e
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < DPT; ++e) acc[i][e] *= corr[i];
#pragma unroll 2
    for (int c = 0; c < BK; c += 4) {
      float pr[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 p4 = *reinterpret_cast<const float4*>(&ps[(4 * ty + i) * BK + c]);
        pr[i][0] = p4.x;
        pr[i][1] = p4.y;
        pr[i][2] = p4.z;
        pr[i][3] = p4.w;
      }
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
#pragma unroll
        for (int e = 0; e < DPT; ++e) {
          const float vv = vs[(c + cc) * DH + tx + 16 * e];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][e] = fmaf(pr[i][cc], vv, acc[i][e]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= sq) continue;
    const float denom = fmaxf(l_i[i], 1e-30f);
    float* orow = o + ((size_t)bh * sq + row) * DH;
#pragma unroll
    for (int e = 0; e < DPT; ++e) orow[tx + 16 * e] = acc[i][e] / denom;
  }
}

template <int DH>
constexpr int smem_bytes() {
  return (DH * BQ + DH * BK + BK * DH + BQ * BK) * (int)sizeof(float);
}

template <int DPT>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int bhq, int bhkv,
                   int sq, int sk, int causal, int window, float scale, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<16 * DPT>();
  auto kernel = flash_fwd_kernel<DPT>;
  // above 48 KB a block's shared memory must be opted into
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + BQ - 1) / BQ, bhq);
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), sq, sk, bhq / bhkv, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o fp32, contiguous, 16-byte aligned. window <= 0 means no
// window. Returns the cudaError_t of the launch (cudaErrorInvalidValue for
// a head width the kernel does not take).
extern "C" int flash_fwd_f32(const void* q, const void* k, const void* v, void* o, int bhq,
                             int bhkv, int sq, int sk, int dh, int causal, int window,
                             float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_CASE(DPT) \
  case 16 * DPT:        \
    return launch<DPT>(q, k, v, o, bhq, bhkv, sq, sk, causal, window, scale, s);
  switch (dh) {
    FLASH_CASE(1)
    FLASH_CASE(2)
    FLASH_CASE(3)
    FLASH_CASE(4)
    FLASH_CASE(5)
    FLASH_CASE(6)
    FLASH_CASE(7)
    FLASH_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef FLASH_CASE
}
