// Flash attention forward for NVIDIA Hopper (sm_90a) on the tensor cores,
// for fp32 q/k/v, to fp32 accuracy: every product is taken as three TF32
// products (3xTF32). GQA, causal and sliding-window masks, online softmax,
// skipping of fully masked kv tiles. bf16 inputs go to the kernel of
// flash_attention_wgmma.cu instead (see kernel.py).
//
// Replaces, for fp32 inputs, the TPU kernel `flash_attention_bhsd` (body
// `_flash_kernel`) of src/repro/kernels/flash_attention/kernel.py and
// computes exactly its function:
//   * q (BHq, Sq, Dh), k/v (BHkv, Sk, Dh), fp32, contiguous; query
//     head h reads kv head h / (BHq / BHkv); Dh in 16..128, a multiple of 16;
//   * s = q.k * scale (scale = 1/sqrt(Dh), passed in), masked where
//     k_pos > q_pos (causal) or k_pos <= q_pos - window, positions from 0
//     for q and k alike, with the FINITE mask value -1e30;
//   * online softmax in fp32 (m, l, acc), o = acc / max(l, 1e-30);
//   * kv tiles entirely in the future or behind the window are skipped, not
//     masked.
// Ragged lengths (Sq, Sk not multiples of the tile) are masked inside: key
// slots past Sk score -inf (weight exactly 0, and m never falls below its
// finite start), their K/V are zero-filled, and rows past Sq are not
// written. The finite -1e30 matters with a window: a row's first live tile
// can be fully masked for that row; its weights then sum garbage into (l,
// acc) with m = -1e30, and the first real key's correction exp(-1e30 - m)
// is exactly 0, as in the reference. With -inf, exp(-inf - -inf) is NaN.
//
// What bounds it on this card: attention does ~Dh/4 FLOP per byte of fp32
// q/k/v/o, above the H100's ridge, so the bound is the operations: 4*Dh
// FLOP per live (q, k) pair. One TF32 product keeps 11 significant bits
// and misses the reference's fp32 tolerance (5e-5) by ~20x. Three do not:
// with x = hi + lo, hi = tf32(x) (rounded to nearest) and lo = x - hi
// (exact in fp32; the tensor core reads its top 11 bits), a*b is taken as
// a_lo*b_hi + a_hi*b_lo + a_hi*b_hi in fp32 accumulators, which keeps ~22
// bits of each product (CUTLASS's 3xTF32; tests/test_torch_flash_kernel.py's
// tf32x3_model is this arithmetic in plain torch). Three TF32 products at
// the tensor cores' TF32 rate still cost less than one fp32 FMA on the CUDA
// cores, so that is the bound this kernel works against.
//
// Design. A block owns 128 query rows (8 warps of 16 rows) and walks the
// live kv tiles of 64 keys. Q (once) and each K/V tile come into shared
// memory by cp.async, the next tile's copies in flight while this tile
// computes (two stages, one barrier a tile). Rows are padded to Dh + 4
// floats, so the fragment loads below are free of bank conflicts. Each warp
// takes its fragments as fp32 and splits them in registers (an integer add,
// a mask and a subtraction a value): it trades issue slots, which the
// tensor cores leave spare, for the shared memory that hi/lo planes would
// take (two stages of split K/V do not fit beside Q at Dh 128) and for the
// bandwidth of reading two planes. mma.sync.m16n8k8 (tf32 in, fp32
// accumulate):
//   * S = Q K^T: Q's A fragments and K's B fragments by ldmatrix (an 8x8
//     b16 matrix is an 8x4 fp32 one, which lands in the tf32 fragment
//     layout); the small products of S go to their own accumulator, so the
//     large one takes one rounding a k-step, not three;
//   * P stays in registers: S's accumulator tile (rows g, g + 8; columns
//     2t, 2t + 1) is P V's A fragment when the k-step's keys are taken in
//     the order 0, 2, 4, 6, 1, 3, 5, 7, and V's B fragment is read in the
//     same order (b0 from key 2t, b1 from key 2t + 1);
//   * V's B fragments as 16-byte loads: within a group of four n-tiles
//     (two where Dh is not a multiple of 32), column g of n-tile i is dim
//     4g + i, so one load brings a lane its value for all four, and the
//     accumulator ends as eight contiguous dims a row per lane for the
//     store.
// Softmax in base 2 (scale * log2 e folded into one multiply, ex2); each
// lane sums its own part of a row's l, the four lanes of a row add up at
// the end. A warp skips a tile entirely in its rows' future (its weights
// there are exactly 0), and masks only tiles that cross a mask's edge.
//
// The PTX helpers (cp.async, ldmatrix, the tf32 mma.sync, ex2), split and
// Vec are sm80_tf32.cuh's, shared with the fp32 backward
// (flash_attention_bwd_tf32.cu).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC, with the other flash sources, into one library
// (kernels/flash_attention/_build.py); entry point flash_fwd_f32, and
// flash_fwd_f32_smem_bytes for a block's dynamic shared memory, bound with
// ctypes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm80_tf32.cuh"

namespace {

constexpr int BQ = 128;       // query rows a block
constexpr int BK = 64;        // keys a kv tile
constexpr int KT = BK / 8;    // n-tiles of S, k-steps of P V
constexpr int WARPS = BQ / 16;
constexpr int THREADS = 32 * WARPS;
constexpr float MASKED = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Shapes and the shared-memory plan of one head width.
template <int DH>
struct Plan {
  static_assert(DH % 16 == 0 && DH >= 16 && DH <= 128, "head width");
  static constexpr int RS = DH + 4;  // row stride (floats): RS / 4 odd, no bank conflicts
  static constexpr int NT = DH / 8;  // n-tiles of the output, k-steps of S
  static constexpr int G = DH % 32 == 0 ? 4 : 2;  // n-tiles that share a V load
  static constexpr int Q_OFF = 0;                 // Q [BQ][RS]
  static constexpr int K_OFF = BQ * RS;           // K [2][BK][RS]
  static constexpr int V_OFF = K_OFF + 2 * BK * RS;  // V [2][BK][RS]
  static constexpr int BYTES = (V_OFF + 2 * BK * RS) * (int)sizeof(float);
};

// rows [r0, r0 + n_rows) of src (n rows of DH) into dst (stride RS) by
// 16-byte cp.async; rows past n are zero-filled
template <int DH>
__device__ __forceinline__ void issue_rows(float* dst, const float* src, int r0, int n_rows,
                                           int n) {
  constexpr int NV = DH / 4;
  for (int i = threadIdx.x; i < n_rows * NV; i += THREADS) {
    const int r = i / NV, c = 4 * (i % NV);
    const bool live = r0 + r < n;
    cp_async16(dst + r * Plan<DH>::RS + c, live ? src + (size_t)(r0 + r) * DH + c : src,
               live ? 16 : 0);
  }
}

// grid (BHq, ceil(Sq / BQ)), THREADS threads, Plan<DH>::BYTES dynamic
// shared memory.
template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                 int sq, int sk, int group, int causal, int window, float scale) {
  using P = Plan<DH>;
  constexpr int RS = P::RS, NT = P::NT, G = P::G;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qs = smem + P::Q_OFF;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n_q = gridDim.y;
  const int q0 = (n_q - 1 - (int)blockIdx.y) * BQ;  // longest rows launch first
  const int bh = blockIdx.x;
  const float* qh = q + (size_t)bh * sq * DH;
  const float* kh = k + (size_t)(bh / group) * sk * DH;
  const float* vh = v + (size_t)(bh / group) * sk * DH;

  // the live kv tiles: none entirely in the future, none entirely behind
  // the window, for any row of this block
  const int q_last = min(q0 + BQ, sq) - 1;
  int t_begin = 0, t_end = (sk + BK - 1) / BK;
  if (causal) t_end = min(t_end, q_last / BK + 1);
  if (window > 0 && q0 - window + 1 > 0) t_begin = (q0 - window + 1) / BK;

  issue_rows<DH>(qs, qh, q0, BQ, sq);
  if (t_begin < t_end) {
    issue_rows<DH>(smem + P::K_OFF, kh, t_begin * BK, BK, sk);
    issue_rows<DH>(smem + P::V_OFF, vh, t_begin * BK, BK, sk);
  }
  cp_async_commit();

  const int w0 = q0 + 16 * warp;  // this warp's first row
  const float sl2 = scale * LOG2E;
  // ldmatrix row addresses: Q's A fragment (rows w0 + (l % 8) + 8 ((l / 8) % 2),
  // dims + 4 (l / 16)) and K's B fragments (key l % 8 of an n-tile, dims
  // + 4 (l / 8): two k-steps)
  const float* qa = qs + (16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1)) * RS + 4 * (lane >> 4);
  const int ka = (lane & 7) * RS + 4 * (lane >> 3);

  float m_r[2] = {MASKED, MASKED}, l_r[2] = {0.f, 0.f};
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int tile = t_begin; tile < t_end; ++tile) {
    const int stage = (tile - t_begin) & 1;
    cp_async_wait_all();
    __syncthreads();  // this tile is in for all; all are done with the other stage
    if (tile + 1 < t_end) {
      issue_rows<DH>(smem + P::K_OFF + (stage ^ 1) * BK * RS, kh, (tile + 1) * BK, BK, sk);
      issue_rows<DH>(smem + P::V_OFF + (stage ^ 1) * BK * RS, vh, (tile + 1) * BK, BK, sk);
      cp_async_commit();
    }
    const int k0 = tile * BK;
    if (w0 >= sq || (causal && k0 > w0 + 15)) continue;  // no row here sees this tile
    const float* ks = smem + P::K_OFF + stage * BK * RS;
    const float* vs = smem + P::V_OFF + stage * BK * RS;

    // S = Q K^T, 16 rows x BK keys: the large products and the small ones
    // in separate accumulators
    float s[KT][4], s_lo[KT][4];
#pragma unroll
    for (int j = 0; j < KT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = s_lo[j][e] = 0.f;
#pragma unroll
    for (int kp = 0; kp < DH / 16; ++kp) {  // k-steps 2kp, 2kp + 1
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t x[4];
        ldsm_x4(qa + 16 * kp + 8 * h, x);
#pragma unroll
        for (int e = 0; e < 4; ++e) split(__uint_as_float(x[e]), ah[h][e], al[h][e]);
      }
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        uint32_t x[4], bh[4], bl[4];
        ldsm_x4(ks + 8 * j * RS + ka + 16 * kp, x);
#pragma unroll
        for (int e = 0; e < 4; ++e) split(__uint_as_float(x[e]), bh[e], bl[e]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mma_tf32(s_lo[j], al[h], bh[2 * h], bh[2 * h + 1]);
          mma_tf32(s_lo[j], ah[h], bl[2 * h], bl[2 * h + 1]);
          mma_tf32(s[j], ah[h], bh[2 * h], bh[2 * h + 1]);
        }
      }
    }

    // scores in base 2, masks where the tile crosses one, online softmax
    const bool edge = k0 + BK > sk || (causal && k0 + BK - 1 > w0) ||
                      (window > 0 && k0 <= w0 + 15 - window);
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int j = 0; j < KT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = (s[j][e] + s_lo[j][e]) * sl2;
        if (edge) {
          const int row = w0 + g + 8 * (e >> 1), col = k0 + 8 * j + 2 * t + (e & 1);
          if (col >= sk) {
            x = -INFINITY;  // ragged tail: no key here
          } else if ((causal && col > row) || (window > 0 && col <= row - window)) {
            x = MASKED;
          }
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // a row's BK keys live in the 4 lanes of its g
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = ex2(m_r[r] - mx[r]);
      m_r[r] = mx[r];
      l_r[r] *= corr[r];
    }
#pragma unroll
    for (int j = 0; j < KT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = ex2(s[j][e] - m_r[e >> 1]);
        l_r[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];

    // acc += P V: k-step kk is S's n-tile kk, its keys in the order
    // 0, 2, 4, 6, 1, 3, 5, 7
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t ph[4], pl[4];
      split(s[kk][0], ph[0], pl[0]);
      split(s[kk][2], ph[1], pl[1]);
      split(s[kk][1], ph[2], pl[2]);
      split(s[kk][3], ph[3], pl[3]);
      const float* v0 = vs + (8 * kk + 2 * t) * RS + G * g;
#pragma unroll
      for (int grp = 0; grp < NT / G; ++grp) {
        using V = Vec<G>;
        const typename V::T x0 = *reinterpret_cast<const typename V::T*>(v0 + 8 * G * grp);
        const typename V::T x1 = *reinterpret_cast<const typename V::T*>(v0 + RS + 8 * G * grp);
#pragma unroll
        for (int i = 0; i < G; ++i) {
          uint32_t b0h, b0l, b1h, b1l;
          split(V::at(x0, i), b0h, b0l);
          split(V::at(x1, i), b1h, b1l);
          float(&d)[4] = acc[G * grp + i];
          mma_tf32(d, pl, b0h, b1h);
          mma_tf32(d, ph, b0l, b1l);
          mma_tf32(d, ph, b0h, b1h);
        }
      }
    }
  }
  cp_async_wait_all();  // nothing left in flight at exit

  // o = acc / l; lane (g, t) holds dims 8G grp + 2G t + [0, 2G) of rows g, g + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = w0 + g + 8 * r;
    if (row >= sq) continue;
    // the row's log-sum-exp for the backward: m and l are in base 2 of
    // the scaled scores
    if (lse != nullptr && t == 0)
      lse[(size_t)bh * sq + row] = (m_r[r] + log2f(fmaxf(l, 1e-30f))) * LN2;
    const float inv = 1.f / fmaxf(l, 1e-30f);
    float* orow = o + ((size_t)bh * sq + row) * DH;
#pragma unroll
    for (int grp = 0; grp < NT / G; ++grp) {
      float out[2 * G];
#pragma unroll
      for (int i = 0; i < G; ++i) {
        out[i] = acc[G * grp + i][2 * r] * inv;
        out[G + i] = acc[G * grp + i][2 * r + 1] * inv;
      }
      float4* dst = reinterpret_cast<float4*>(orow + 8 * G * grp + 2 * G * t);
#pragma unroll
      for (int c = 0; c < G / 2; ++c)
        dst[c] = make_float4(out[4 * c], out[4 * c + 1], out[4 * c + 2], out[4 * c + 3]);
    }
  }
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse, int bhq,
                   int bhkv, int sq, int sk, int causal, int window, float scale,
                   cudaStream_t stream) {
  constexpr int bytes = Plan<DH>::BYTES;
  auto kernel = flash_fwd_kernel<DH>;
  // above 48 KB a block's shared memory must be opted into
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int n_q = (sq + BQ - 1) / BQ;
  if (n_q > 65535) return cudaErrorInvalidValue;
  const dim3 grid(bhq, n_q);
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<float*>(lse), sq, sk, bhq / bhkv, causal, window,
      scale);
  return cudaGetLastError();
}

}  // namespace

#define FLASH_WIDTHS(X) X(16) X(32) X(48) X(64) X(80) X(96) X(112) X(128)

// q, k, v, o fp32, contiguous, 16-byte aligned. lse: null, or (BHq, Sq)
// fp32 for each row's log-sum-exp of its scaled scores (the backward's
// input). window <= 0 means no window. Returns the cudaError_t of the
// launch (cudaErrorInvalidValue for a head width the kernel does not take).
extern "C" int flash_fwd_f32(const void* q, const void* k, const void* v, void* o, void* lse,
                             int bhq, int bhkv, int sq, int sk, int dh, int causal, int window,
                             float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_CASE(DH) \
  case DH:             \
    return launch<DH>(q, k, v, o, lse, bhq, bhkv, sq, sk, causal, window, scale, s);
  switch (dh) {
    FLASH_WIDTHS(FLASH_CASE)
    default:
      return cudaErrorInvalidValue;
  }
#undef FLASH_CASE
}

// The dynamic shared memory a block of head width dh launches with (0 for a
// width the kernel does not take).
extern "C" int flash_fwd_f32_smem_bytes(int dh) {
#define FLASH_BYTES(DH) \
  case DH:              \
    return Plan<DH>::BYTES;
  switch (dh) {
    FLASH_WIDTHS(FLASH_BYTES)
    default:
      return 0;
  }
#undef FLASH_BYTES
}
