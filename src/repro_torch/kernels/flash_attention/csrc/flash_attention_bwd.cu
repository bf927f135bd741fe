// Flash attention backward for NVIDIA Hopper (sm_90a): dQ, dK and dV of
// the function that flash_attention.cu (fp32) and flash_attention_wgmma.cu
// (bf16) compute, from q, k, v, the forward's output o, the output's
// gradient do and the row log-sum-exp (LSE) that those kernels emit.
//
// Replaces no TPU kernel of its own: the reference's training step
// differentiates its jnp attention (src/repro/models/attention.py,
// `attention_chunked`) by autodiff and never calls the Pallas kernel
// `flash_attention_bhsd` (src/repro/kernels/flash_attention/kernel.py:124).
// The port's forward runs the CUDA kernels, so its gradient needs this
// kernel; it computes the gradients that autodiff of the reference's
// attention gives (kernels/flash_attention/ref.py, `attention_bwd_ref`):
//   * q (BHq, Sq, Dh), k/v (BHkv, Sk, Dh), o/do like q, lse (BHq, Sq) fp32,
//     all contiguous; query head h reads kv head h / (BHq / BHkv);
//     Dh in 16..128, a multiple of 16;
//   * live pairs: k_pos <= q_pos (causal), k_pos > q_pos - window (window
//     > 0), k_pos < Sk, q_pos < Sq, positions from 0 for q and k alike;
//   * P = exp(s * scale - lse) on live pairs, 0 elsewhere (the forward's
//     finite -1e30 mask gives exactly 0 there); D = rowsum(do * o) in fp32;
//     dS = P * (do v^T - D);
//   * dV = sum over the group's query heads of P^T do, dK = the same of
//     dS^T q * scale, dQ = dS k * scale.
// Rows with no live key at all lie outside the contract, as in the
// forward; the autograd Function refuses the calls that have them.
//
// Three entries a dtype, one launch each a call:
//   * flash_bwd_pre_*: D = rowsum(do * o), a warp a row, in fp32;
//   * flash_bwd_dkdv_*: a block owns one tile of keys of one kv head; it
//     loops over the group's query heads and the query tiles that can reach
//     the tile, recomputes P from q, k and the LSE, and accumulates dV and
//     dK in registers;
//   * flash_bwd_dq_*: a block owns one tile of query rows; it loops over
//     the key tiles in reach and accumulates dQ in registers.
// No block adds into another's output, so there are no atomics and every
// sum is taken in the same order in every run: the results are
// deterministic, bit for bit.
//
// bf16: the products on the tensor cores, mma.sync.m16n8k16 (bf16 in, fp32
// accumulate), tiles of 64 x 64 in four warps of 16 rows. P and dS are
// rounded to bf16 as the A operands of dV, dK and dQ (as tensor-core flash
// kernels do; a relative 2^-9 a term). The operands that a product reads
// along the other axis (q^T and do^T for dK/dV, k^T for dQ) are stored a
// second time, transposed, in shared memory, so every fragment is one
// 32-bit load of two neighbouring elements. fp32 (the parity yardstick
// only): CUDA-core FMA on tiles of 32 x 32, 256 threads, with P and dS
// through shared memory.
//
// What bounds it on this card: 10 * Dh FLOP a live pair (five products of
// 2 * Dh: the recomputed s, do v^T, dV, dK, dQ; this kernel recomputes s
// and do v^T in both the dK/dV and the dQ pass, 14 * Dh in all). Causal
// at Sq = Sk = S that is about 5 S / 16 FLOP a byte of q, k, v, o, do and
// the gradients (1,280 at S 4096), far above the H100's ~295: the bound is
// the operations at the bf16 tensor-core rate. A simple design, right
// first: no TMA, no cp.async pipeline, no wgmma; the transposed tiles are
// written to shared memory an element at a time.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3, compiled beside
// flash_attention.cu and flash_attention_wgmma.cu into one library
// (kernels/flash_attention/_build.py); entry points bound with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// ---- PTX helpers
// d += a b, a 16 x 16 (row), b 16 x 8 (col), bf16 in, fp32 accumulate. With
// g = lane / 4, t = lane % 4: a holds rows g (a[0]) and g + 8 (a[1]) at
// columns 2t, 2t + 1, and the same rows at columns 2t + 8, 2t + 9 (a[2],
// a[3]); b holds rows 2t, 2t + 1 (b0) and 2t + 8, 2t + 9 (b1) of column g;
// d holds rows g (d[0], d[1]) and g + 8 (d[2], d[3]) at columns 2t, 2t + 1.
// Two bf16 in one register: the lower column (row of b) in the low half.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// ---- end PTX helpers

// two floats as bf16 (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// two neighbouring bf16 of shared memory (an even element offset)
__device__ __forceinline__ uint32_t ld2(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

constexpr float LOG2E = 1.4426950408889634f;

// The live pairs, and the reach of a tile along the other axis.
struct Mask {
  int sq, sk, causal, window;

  __device__ __forceinline__ bool live(int q, int k) const {
    return q < sq && k < sk && (!causal || k <= q) && (window <= 0 || k > q - window);
  }
  // the query rows [lo, hi) that see some key of [k0, k1)
  __device__ __forceinline__ void rows(int k0, int k1, int& lo, int& hi) const {
    lo = causal ? k0 : 0;
    hi = window > 0 ? min(sq, k1 - 1 + window) : sq;
  }
  // the keys [lo, hi) that some row of [q0, q1) sees
  __device__ __forceinline__ void keys(int q0, int q1, int& lo, int& hi) const {
    lo = window > 0 ? max(0, q0 - window + 1) : 0;
    hi = causal ? min(sk, q1) : sk;
  }
};

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

// ------------------------------------------------------ bf16, mma.sync
constexpr int MMA_THREADS = 128;  // four warps of 16 rows
constexpr int MT = 64;            // a block's keys (dK/dV) or query rows (dQ)
constexpr int NT_STEP = 64;       // a step's query rows (dK/dV) or keys (dQ)

// Shared-memory plan of one head width. Row-major tiles are 64 rows of
// DH + 8 bf16 and transposed tiles DH rows of 64 + 8: the 16-byte pad puts
// the eight rows g of a fragment load in distinct banks.
template <int DH>
struct MmaPlan {
  static_assert(DH % 16 == 0 && DH >= 16 && DH <= 128, "head width");
  static constexpr int RS = DH + 8;       // row stride of a 64 x DH tile
  static constexpr int TS = NT_STEP + 8;  // row stride of a DH x 64 tile
  static constexpr int KT = DH / 16;      // k-steps over the head width
  static constexpr int NT = DH / 8;       // n-tiles over the head width
  static constexpr int TILE = 64 * RS;    // elements
  static constexpr int TTILE = DH * TS;
  // dK/dV: K, V, Q, dO, Q^T, dO^T, then lse * log2(e) and D for 64 rows
  static constexpr int DKDV_BYTES = (4 * TILE + 2 * TTILE) * 2 + 2 * 64 * 4;
  // dQ: Q, dO, K, V, K^T
  static constexpr int DQ_BYTES = (4 * TILE + TTILE) * 2;
};

// rows [r0, r0 + 64) of src (n rows of DH bf16) into dst (row stride RS)
// and, if dst_t is given, transposed into dst_t (row stride TS); rows past
// n are zeros
template <int DH>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, __nv_bfloat16* dst_t,
                                          const __nv_bfloat16* __restrict__ src, int r0, int n) {
  using L = MmaPlan<DH>;
  constexpr int V = DH / 8;  // 16-byte vectors a row
  for (int i = threadIdx.x; i < 64 * V; i += MMA_THREADS) {
    const int r = i / V, c = 8 * (i % V);
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n) x = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * DH + c);
    *reinterpret_cast<uint4*>(dst + r * L::RS + c) = x;
    if (dst_t != nullptr) {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&x);
#pragma unroll
      for (int j = 0; j < 8; ++j) dst_t[(c + j) * L::TS + r] = e[j];
    }
  }
}

// The A fragment of rows [r, r + 16), columns [c, c + 16) of a row-major
// tile (stride RS)
template <int RS>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const __nv_bfloat16* tile, int r, int c,
                                       int g, int t) {
  const __nv_bfloat16* p = tile + (r + g) * RS + c + 2 * t;
  a[0] = ld2(p);
  a[1] = ld2(p + 8 * RS);
  a[2] = ld2(p + 8);
  a[3] = ld2(p + 8 * RS + 8);
}

// The A fragment of a 16 x 16 block held as two accumulator n-tiles (the
// left and right 8 columns), rounded to bf16
__device__ __forceinline__ void frag_a_acc(uint32_t (&a)[4], const float (&left)[4],
                                           const float (&right)[4]) {
  a[0] = pack_bf16(left[0], left[1]);
  a[1] = pack_bf16(left[2], left[3]);
  a[2] = pack_bf16(right[0], right[1]);
  a[3] = pack_bf16(right[2], right[3]);
}

// acc[j] += A . B^T for the 8 n-tiles j of a 64-row tile B (stride RS):
// column n of n-tile j is row 8j + n of B, the k-steps run over B's
// columns [16 kk, 16 kk + 16) with A the k-step's fragment
template <int RS>
__device__ __forceinline__ void mma_rows(float (&acc)[8][4], const uint32_t (&a)[4],
                                         const __nv_bfloat16* tile, int kk, int g, int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const __nv_bfloat16* p = tile + (8 * j + g) * RS + 16 * kk + 2 * t;
    mma_bf16(acc[j], a, ld2(p), ld2(p + 8));
  }
}

// The dK/dV pass. grid (ceil(Sk / 64), BHkv), MMA_THREADS threads,
// MmaPlan<DH>::DKDV_BYTES of dynamic shared memory. Warp w owns keys
// k0 + 16w .. + 15; S^T and dP^T (16 keys x 64 rows a step) stay in its
// registers and become P^T and dS^T there.
template <int DH>
__global__ void __launch_bounds__(MMA_THREADS)
bwd_dkdv_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ d_o,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int sq,
                    int sk, int group, int causal, int window, float scale) {
  using L = MmaPlan<DH>;
  extern __shared__ uint4 smem_u4[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_u4);
  __nv_bfloat16* vs = ks + L::TILE;
  __nv_bfloat16* qs = vs + L::TILE;
  __nv_bfloat16* dos = qs + L::TILE;
  __nv_bfloat16* qts = dos + L::TILE;
  __nv_bfloat16* dots = qts + L::TTILE;
  float* lse2_s = reinterpret_cast<float*>(dots + L::TTILE);
  float* delta_s = lse2_s + NT_STEP;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * MT, bkv = blockIdx.y;
  const int kr = 16 * warp;  // this warp's first key row of the tile
  const Mask mask{sq, sk, causal, window};
  const float sl2 = scale * LOG2E;

  load_tile<DH>(ks, nullptr, k + (size_t)bkv * sk * DH, k0, sk);
  load_tile<DH>(vs, nullptr, v + (size_t)bkv * sk * DH, k0, sk);
  int q_lo, q_hi;
  mask.rows(k0, min(k0 + MT, sk), q_lo, q_hi);

  float dk_acc[L::NT][4], dv_acc[L::NT][4];
#pragma unroll
  for (int n = 0; n < L::NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int h = 0; h < group; ++h) {
    const int bh = bkv * group + h;
    const __nv_bfloat16* qh = q + (size_t)bh * sq * DH;
    const __nv_bfloat16* doh = d_o + (size_t)bh * sq * DH;
    for (int q0 = q_lo / NT_STEP * NT_STEP; q0 < q_hi; q0 += NT_STEP) {
      __syncthreads();  // every warp is done with the last step's tiles
      load_tile<DH>(qs, qts, qh, q0, sq);
      load_tile<DH>(dos, dots, doh, q0, sq);
      if (threadIdx.x < NT_STEP) {
        const int row = q0 + threadIdx.x;
        lse2_s[threadIdx.x] = row < sq ? lse[(size_t)bh * sq + row] * LOG2E : 0.f;
        delta_s[threadIdx.x] = row < sq ? delta[(size_t)bh * sq + row] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: 16 keys x 64 rows
      float s[8][4], dp[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < L::KT; ++kk) {
        uint32_t a[4];
        frag_a<L::RS>(a, ks, kr, 16 * kk, g, t);
        mma_rows<L::RS>(s, a, qs, kk, g, t);
        frag_a<L::RS>(a, vs, kr, 16 * kk, g, t);
        mma_rows<L::RS>(dp, a, dos, kk, g, t);
      }
      // P^T and dS^T in place; element e of n-tile j: key kr + g + 8 (e / 2),
      // row 8j + 2t + e % 2 of the step
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + kr + g + 8 * (e >> 1), r = 8 * j + 2 * t + (e & 1);
          const float p = mask.live(q0 + r, key) ? exp2f(s[j][e] * sl2 - lse2_s[r]) : 0.f;
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - delta_s[r]);
        }
      // dV += P^T dO, dK += dS^T Q: the k-steps run over the step's rows;
      // B's column n (a head dim) of n-tile m is row 8m + n of dO^T, Q^T
#pragma unroll
      for (int kk = 0; kk < NT_STEP / 16; ++kk) {
        uint32_t ap[4], ads[4];
        frag_a_acc(ap, s[2 * kk], s[2 * kk + 1]);
        frag_a_acc(ads, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int m = 0; m < L::NT; ++m) {
          const __nv_bfloat16* pd = dots + (8 * m + g) * L::TS + 16 * kk + 2 * t;
          mma_bf16(dv_acc[m], ap, ld2(pd), ld2(pd + 8));
          const __nv_bfloat16* pq = qts + (8 * m + g) * L::TS + 16 * kk + 2 * t;
          mma_bf16(dk_acc[m], ads, ld2(pq), ld2(pq + 8));
        }
      }
    }
  }

  // dK (times the scale) and dV of keys below Sk; every key is written,
  // zeros where no row sees it
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + kr + g + 8 * i;
    if (key >= sk) continue;
    const size_t row = ((size_t)bkv * sk + key) * DH;
#pragma unroll
    for (int m = 0; m < L::NT; ++m) {
      const int col = 8 * m + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(dk + row + col) =
          __floats2bfloat162_rn(dk_acc[m][2 * i] * scale, dk_acc[m][2 * i + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + row + col) =
          __floats2bfloat162_rn(dv_acc[m][2 * i], dv_acc[m][2 * i + 1]);
    }
  }
}

// The dQ pass. grid (ceil(Sq / 64), BHq), MMA_THREADS threads,
// MmaPlan<DH>::DQ_BYTES of dynamic shared memory. Warp w owns rows
// q0 + 16w .. + 15; S and dP (16 rows x 64 keys a step) stay in its
// registers, dS becomes the A operand of dQ += dS K.
template <int DH>
__global__ void __launch_bounds__(MMA_THREADS)
bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ d_o,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  __nv_bfloat16* __restrict__ dq, int sq, int sk, int group, int causal,
                  int window, float scale) {
  using L = MmaPlan<DH>;
  extern __shared__ uint4 smem_u4[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_u4);
  __nv_bfloat16* dos = qs + L::TILE;
  __nv_bfloat16* ks = dos + L::TILE;
  __nv_bfloat16* vs = ks + L::TILE;
  __nv_bfloat16* kts = vs + L::TILE;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * MT, bh = blockIdx.y, bkv = bh / group;
  const int qr = 16 * warp;  // this warp's first row of the tile
  const Mask mask{sq, sk, causal, window};
  const float sl2 = scale * LOG2E;
  const __nv_bfloat16* kh = k + (size_t)bkv * sk * DH;
  const __nv_bfloat16* vh = v + (size_t)bkv * sk * DH;

  load_tile<DH>(qs, nullptr, q + (size_t)bh * sq * DH, q0, sq);
  load_tile<DH>(dos, nullptr, d_o + (size_t)bh * sq * DH, q0, sq);
  float lse2[2], dl[2];  // rows q0 + qr + g and + 8
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + qr + g + 8 * i;
    lse2[i] = row < sq ? lse[(size_t)bh * sq + row] * LOG2E : 0.f;
    dl[i] = row < sq ? delta[(size_t)bh * sq + row] : 0.f;
  }
  int k_lo, k_hi;
  mask.keys(q0, min(q0 + MT, sq), k_lo, k_hi);

  float dq_acc[L::NT][4];
#pragma unroll
  for (int n = 0; n < L::NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[n][e] = 0.f;

  for (int kt0 = k_lo / NT_STEP * NT_STEP; kt0 < k_hi; kt0 += NT_STEP) {
    __syncthreads();  // every warp is done with the last step's tiles
    load_tile<DH>(ks, kts, kh, kt0, sk);
    load_tile<DH>(vs, nullptr, vh, kt0, sk);
    __syncthreads();

    // S = Q K^T and dP = dO V^T: 16 rows x 64 keys
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < L::KT; ++kk) {
      uint32_t a[4];
      frag_a<L::RS>(a, qs, qr, 16 * kk, g, t);
      mma_rows<L::RS>(s, a, ks, kk, g, t);
      frag_a<L::RS>(a, dos, qr, 16 * kk, g, t);
      mma_rows<L::RS>(dp, a, vs, kk, g, t);
    }
    // dS in place; element e of n-tile j: row qr + g + 8 (e / 2), key
    // kt0 + 8j + 2t + e % 2
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = q0 + qr + g + 8 * (e >> 1), key = kt0 + 8 * j + 2 * t + (e & 1);
        const float p = mask.live(row, key) ? exp2f(s[j][e] * sl2 - lse2[e >> 1]) : 0.f;
        s[j][e] = p * (dp[j][e] - dl[e >> 1]);
      }
    // dQ += dS K: the k-steps run over the step's keys; B's column n (a
    // head dim) of n-tile m is row 8m + n of K^T
#pragma unroll
    for (int kk = 0; kk < NT_STEP / 16; ++kk) {
      uint32_t a[4];
      frag_a_acc(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int m = 0; m < L::NT; ++m) {
        const __nv_bfloat16* pk = kts + (8 * m + g) * L::TS + 16 * kk + 2 * t;
        mma_bf16(dq_acc[m], a, ld2(pk), ld2(pk + 8));
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + qr + g + 8 * i;
    if (row >= sq) continue;
    __nv_bfloat16* out = dq + ((size_t)bh * sq + row) * DH;
#pragma unroll
    for (int m = 0; m < L::NT; ++m)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * m + 2 * t) =
          __floats2bfloat162_rn(dq_acc[m][2 * i] * scale, dq_acc[m][2 * i + 1] * scale);
  }
}

// ------------------------------------------------------- fp32, CUDA cores
constexpr int F_THREADS = 256;
constexpr int FB = 32;  // a tile's rows and a step's rows, both passes

// Shared-memory plan of one head width: fp32 tiles of 32 rows of DH + 1
// (a column read by lanes of different rows hits different banks), P and
// dS tiles of 32 x 33.
template <int DH>
struct F32Plan {
  static_assert(DH % 16 == 0 && DH >= 16 && DH <= 128, "head width");
  static constexpr int RS = DH + 1;
  static constexpr int PS = FB + 1;
  static constexpr int TILE = FB * RS;
  static constexpr int D8 = DH / 8;  // head dims a thread accumulates
  // dK/dV: K, V, Q, dO, P, dS, lse, D
  static constexpr int DKDV_BYTES = (4 * TILE + 2 * FB * PS + 2 * FB) * 4;
  // dQ: Q, dO, K, V, dS, lse, D
  static constexpr int DQ_BYTES = (4 * TILE + FB * PS + 2 * FB) * 4;
};

// rows [r0, r0 + 32) of src (n rows of DH) into dst (row stride RS); rows
// past n are zeros
template <int DH>
__device__ __forceinline__ void load_f32(float* dst, const float* __restrict__ src, int r0,
                                         int n) {
  for (int i = threadIdx.x; i < FB * DH; i += F_THREADS) {
    const int r = i / DH, c = i % DH;
    dst[r * F32Plan<DH>::RS + c] = r0 + r < n ? src[(size_t)(r0 + r) * DH + c] : 0.f;
  }
}

// lse and D of rows [r0, r0 + 32) of head bh (0 past Sq)
__device__ __forceinline__ void load_rows(float* lse_s, float* delta_s,
                                          const float* __restrict__ lse,
                                          const float* __restrict__ delta, size_t base, int r0,
                                          int sq) {
  if (threadIdx.x < FB) {
    const int row = r0 + threadIdx.x;
    lse_s[threadIdx.x] = row < sq ? lse[base + row] : 0.f;
    delta_s[threadIdx.x] = row < sq ? delta[base + row] : 0.f;
  }
}

// The dK/dV pass in fp32. grid (ceil(Sk / 32), BHkv), F_THREADS threads,
// F32Plan<DH>::DKDV_BYTES of dynamic shared memory. Thread (key kl = tid /
// 8, c = tid % 8) forms P and dS of its key at rows c, c + 8, c + 16,
// c + 24 of a step, then accumulates dK and dV of its key at head dims
// c, c + 8, ...
template <int DH>
__global__ void __launch_bounds__(F_THREADS)
bwd_dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ d_o,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dk, float* __restrict__ dv, int sq, int sk, int group,
                    int causal, int window, float scale) {
  using L = F32Plan<DH>;
  extern __shared__ uint4 smem_u4[];
  float* ks = reinterpret_cast<float*>(smem_u4);
  float* vs = ks + L::TILE;
  float* qs = vs + L::TILE;
  float* dos = qs + L::TILE;
  float* ps = dos + L::TILE;
  float* dss = ps + FB * L::PS;
  float* lse_s = dss + FB * L::PS;
  float* delta_s = lse_s + FB;

  const int kl = threadIdx.x >> 3, c = threadIdx.x & 7;
  const int k0 = blockIdx.x * FB, bkv = blockIdx.y;
  const Mask mask{sq, sk, causal, window};
  load_f32<DH>(ks, k + (size_t)bkv * sk * DH, k0, sk);
  load_f32<DH>(vs, v + (size_t)bkv * sk * DH, k0, sk);
  int q_lo, q_hi;
  mask.rows(k0, min(k0 + FB, sk), q_lo, q_hi);

  float dk_acc[L::D8], dv_acc[L::D8];
#pragma unroll
  for (int i = 0; i < L::D8; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  for (int h = 0; h < group; ++h) {
    const int bh = bkv * group + h;
    for (int q0 = q_lo / FB * FB; q0 < q_hi; q0 += FB) {
      __syncthreads();
      load_f32<DH>(qs, q + (size_t)bh * sq * DH, q0, sq);
      load_f32<DH>(dos, d_o + (size_t)bh * sq * DH, q0, sq);
      load_rows(lse_s, delta_s, lse, delta, (size_t)bh * sq, q0, sq);
      __syncthreads();
      float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
      for (int d = 0; d < DH; ++d) {
        const float kx = ks[kl * L::RS + d], vx = vs[kl * L::RS + d];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[i] = fmaf(kx, qs[(c + 8 * i) * L::RS + d], s[i]);
          dp[i] = fmaf(vx, dos[(c + 8 * i) * L::RS + d], dp[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = c + 8 * i;
        const float p = mask.live(q0 + r, k0 + kl) ? expf(s[i] * scale - lse_s[r]) : 0.f;
        ps[kl * L::PS + r] = p;
        dss[kl * L::PS + r] = p * (dp[i] - delta_s[r]);
      }
      __syncthreads();
      for (int r = 0; r < FB; ++r) {
        const float p = ps[kl * L::PS + r], ds = dss[kl * L::PS + r];
#pragma unroll
        for (int i = 0; i < L::D8; ++i) {
          dv_acc[i] = fmaf(p, dos[r * L::RS + c + 8 * i], dv_acc[i]);
          dk_acc[i] = fmaf(ds, qs[r * L::RS + c + 8 * i], dk_acc[i]);
        }
      }
    }
  }
  const int key = k0 + kl;
  if (key < sk) {
    const size_t row = ((size_t)bkv * sk + key) * DH;
#pragma unroll
    for (int i = 0; i < L::D8; ++i) {
      dk[row + c + 8 * i] = dk_acc[i] * scale;
      dv[row + c + 8 * i] = dv_acc[i];
    }
  }
}

// The dQ pass in fp32. grid (ceil(Sq / 32), BHq), F_THREADS threads,
// F32Plan<DH>::DQ_BYTES of dynamic shared memory. Thread (row ql = tid / 8,
// c = tid % 8) forms dS of its row at keys c, c + 8, c + 16, c + 24 of a
// step, then accumulates dQ of its row at head dims c, c + 8, ...
template <int DH>
__global__ void __launch_bounds__(F_THREADS)
bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ d_o,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  float* __restrict__ dq, int sq, int sk, int group, int causal, int window,
                  float scale) {
  using L = F32Plan<DH>;
  extern __shared__ uint4 smem_u4[];
  float* qs = reinterpret_cast<float*>(smem_u4);
  float* dos = qs + L::TILE;
  float* ks = dos + L::TILE;
  float* vs = ks + L::TILE;
  float* dss = vs + L::TILE;
  float* lse_s = dss + FB * L::PS;
  float* delta_s = lse_s + FB;

  const int ql = threadIdx.x >> 3, c = threadIdx.x & 7;
  const int q0 = blockIdx.x * FB, bh = blockIdx.y, bkv = bh / group;
  const Mask mask{sq, sk, causal, window};
  load_f32<DH>(qs, q + (size_t)bh * sq * DH, q0, sq);
  load_f32<DH>(dos, d_o + (size_t)bh * sq * DH, q0, sq);
  load_rows(lse_s, delta_s, lse, delta, (size_t)bh * sq, q0, sq);
  int k_lo, k_hi;
  mask.keys(q0, min(q0 + FB, sq), k_lo, k_hi);

  float dq_acc[L::D8];
#pragma unroll
  for (int i = 0; i < L::D8; ++i) dq_acc[i] = 0.f;

  for (int kt0 = k_lo / FB * FB; kt0 < k_hi; kt0 += FB) {
    __syncthreads();
    load_f32<DH>(ks, k + (size_t)bkv * sk * DH, kt0, sk);
    load_f32<DH>(vs, v + (size_t)bkv * sk * DH, kt0, sk);
    __syncthreads();
    float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
    for (int d = 0; d < DH; ++d) {
      const float qx = qs[ql * L::RS + d], dox = dos[ql * L::RS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[i] = fmaf(qx, ks[(c + 8 * i) * L::RS + d], s[i]);
        dp[i] = fmaf(dox, vs[(c + 8 * i) * L::RS + d], dp[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kl = c + 8 * i;
      const float p = mask.live(q0 + ql, kt0 + kl) ? expf(s[i] * scale - lse_s[ql]) : 0.f;
      dss[ql * L::PS + kl] = p * (dp[i] - delta_s[ql]);
    }
    __syncthreads();
    for (int kl = 0; kl < FB; ++kl) {
      const float ds = dss[ql * L::PS + kl];
#pragma unroll
      for (int i = 0; i < L::D8; ++i) dq_acc[i] = fmaf(ds, ks[kl * L::RS + c + 8 * i], dq_acc[i]);
    }
  }
  const int row = q0 + ql;
  if (row < sq) {
#pragma unroll
    for (int i = 0; i < L::D8; ++i)
      dq[((size_t)bh * sq + row) * DH + c + 8 * i] = dq_acc[i] * scale;
  }
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

// opts a kernel into `bytes` of dynamic shared memory; grid.y (the heads)
// is at most 65535
template <typename K>
cudaError_t prepare(K kernel, int bytes, int heads) {
  if (heads > 65535) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

struct Call {
  const void *q, *k, *v, *d_o, *lse, *delta;
  void *out0, *out1;
  int bhq, bhkv, sq, sk, causal, window;
  float scale;
  cudaStream_t stream;
};

template <int DH>
cudaError_t launch_dkdv_bf16(const Call& c) {
  using B = __nv_bfloat16;
  auto kernel = bwd_dkdv_mma_kernel<DH>;
  constexpr int bytes = MmaPlan<DH>::DKDV_BYTES;
  const int tiles = (c.sk + MT - 1) / MT;
  cudaError_t err = prepare(kernel, bytes, c.bhkv);
  if (err != cudaSuccess || tiles == 0) return err;
  kernel<<<dim3(tiles, c.bhkv), MMA_THREADS, bytes, c.stream>>>(
      static_cast<const B*>(c.q), static_cast<const B*>(c.k), static_cast<const B*>(c.v),
      static_cast<const B*>(c.d_o), static_cast<const float*>(c.lse),
      static_cast<const float*>(c.delta), static_cast<B*>(c.out0), static_cast<B*>(c.out1),
      c.sq, c.sk, c.bhq / c.bhkv, c.causal, c.window, c.scale);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dq_bf16(const Call& c) {
  using B = __nv_bfloat16;
  auto kernel = bwd_dq_mma_kernel<DH>;
  constexpr int bytes = MmaPlan<DH>::DQ_BYTES;
  const int tiles = (c.sq + MT - 1) / MT;
  cudaError_t err = prepare(kernel, bytes, c.bhq);
  if (err != cudaSuccess || tiles == 0) return err;
  kernel<<<dim3(tiles, c.bhq), MMA_THREADS, bytes, c.stream>>>(
      static_cast<const B*>(c.q), static_cast<const B*>(c.k), static_cast<const B*>(c.v),
      static_cast<const B*>(c.d_o), static_cast<const float*>(c.lse),
      static_cast<const float*>(c.delta), static_cast<B*>(c.out0), c.sq, c.sk,
      c.bhq / c.bhkv, c.causal, c.window, c.scale);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dkdv_f32(const Call& c) {
  auto kernel = bwd_dkdv_f32_kernel<DH>;
  constexpr int bytes = F32Plan<DH>::DKDV_BYTES;
  const int tiles = (c.sk + FB - 1) / FB;
  cudaError_t err = prepare(kernel, bytes, c.bhkv);
  if (err != cudaSuccess || tiles == 0) return err;
  kernel<<<dim3(tiles, c.bhkv), F_THREADS, bytes, c.stream>>>(
      static_cast<const float*>(c.q), static_cast<const float*>(c.k),
      static_cast<const float*>(c.v), static_cast<const float*>(c.d_o),
      static_cast<const float*>(c.lse), static_cast<const float*>(c.delta),
      static_cast<float*>(c.out0), static_cast<float*>(c.out1), c.sq, c.sk, c.bhq / c.bhkv,
      c.causal, c.window, c.scale);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dq_f32(const Call& c) {
  auto kernel = bwd_dq_f32_kernel<DH>;
  constexpr int bytes = F32Plan<DH>::DQ_BYTES;
  const int tiles = (c.sq + FB - 1) / FB;
  cudaError_t err = prepare(kernel, bytes, c.bhq);
  if (err != cudaSuccess || tiles == 0) return err;
  kernel<<<dim3(tiles, c.bhq), F_THREADS, bytes, c.stream>>>(
      static_cast<const float*>(c.q), static_cast<const float*>(c.k),
      static_cast<const float*>(c.v), static_cast<const float*>(c.d_o),
      static_cast<const float*>(c.lse), static_cast<const float*>(c.delta),
      static_cast<float*>(c.out0), c.sq, c.sk, c.bhq / c.bhkv, c.causal, c.window, c.scale);
  return cudaGetLastError();
}

Call make_call(const void* q, const void* k, const void* v, const void* d_o, const void* lse,
               const void* delta, void* out0, void* out1, int bhq, int bhkv, int sq, int sk,
               int causal, int window, float scale, void* stream) {
  return Call{q, k, v, d_o, lse, delta, out0, out1, bhq, bhkv, sq, sk, causal,
              window, scale, static_cast<cudaStream_t>(stream)};
}

bool valid(int bhq, int bhkv, int sq, int sk) {
  return bhq > 0 && bhkv > 0 && bhq % bhkv == 0 && sq >= 0 && sk >= 0;
}

}  // namespace

#define BWD_WIDTHS(X) X(16) X(32) X(48) X(64) X(80) X(96) X(112) X(128)
#define BWD_CASE(DH, FN) \
  case DH:               \
    return FN<DH>(c);

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

// dK into out0 and dV into out1 ((BHkv, Sk, Dh), the dtype of q, k, v),
// from q, k, v, do (16-byte aligned, contiguous), lse (BHq, Sq) and delta
// (BHq, Sq) fp32. window <= 0 means no window. Returns the cudaError_t of
// the launch (cudaErrorInvalidValue for a shape the kernel does not take).
extern "C" int flash_bwd_dkdv_f32(const void* q, const void* k, const void* v, const void* d_o,
                                  const void* lse, const void* delta, void* out0, void* out1,
                                  int bhq, int bhkv, int sq, int sk, int dh, int causal,
                                  int window, float scale, void* stream) {
  if (!valid(bhq, bhkv, sq, sk)) return cudaErrorInvalidValue;
  const Call c = make_call(q, k, v, d_o, lse, delta, out0, out1, bhq, bhkv, sq, sk, causal,
                           window, scale, stream);
#define CASE(DH) BWD_CASE(DH, launch_dkdv_f32)
  switch (dh) {
    BWD_WIDTHS(CASE)
    default:
      return cudaErrorInvalidValue;
  }
#undef CASE
}

extern "C" int flash_bwd_dkdv_bf16(const void* q, const void* k, const void* v, const void* d_o,
                                   const void* lse, const void* delta, void* out0, void* out1,
                                   int bhq, int bhkv, int sq, int sk, int dh, int causal,
                                   int window, float scale, void* stream) {
  if (!valid(bhq, bhkv, sq, sk)) return cudaErrorInvalidValue;
  const Call c = make_call(q, k, v, d_o, lse, delta, out0, out1, bhq, bhkv, sq, sk, causal,
                           window, scale, stream);
#define CASE(DH) BWD_CASE(DH, launch_dkdv_bf16)
  switch (dh) {
    BWD_WIDTHS(CASE)
    default:
      return cudaErrorInvalidValue;
  }
#undef CASE
}

// dQ into out0 ((BHq, Sq, Dh), the dtype of q); out1 is not read. The rest
// as flash_bwd_dkdv_*.
extern "C" int flash_bwd_dq_f32(const void* q, const void* k, const void* v, const void* d_o,
                                const void* lse, const void* delta, void* out0, void* out1,
                                int bhq, int bhkv, int sq, int sk, int dh, int causal,
                                int window, float scale, void* stream) {
  if (!valid(bhq, bhkv, sq, sk)) return cudaErrorInvalidValue;
  const Call c = make_call(q, k, v, d_o, lse, delta, out0, out1, bhq, bhkv, sq, sk, causal,
                           window, scale, stream);
#define CASE(DH) BWD_CASE(DH, launch_dq_f32)
  switch (dh) {
    BWD_WIDTHS(CASE)
    default:
      return cudaErrorInvalidValue;
  }
#undef CASE
}

extern "C" int flash_bwd_dq_bf16(const void* q, const void* k, const void* v, const void* d_o,
                                 const void* lse, const void* delta, void* out0, void* out1,
                                 int bhq, int bhkv, int sq, int sk, int dh, int causal,
                                 int window, float scale, void* stream) {
  if (!valid(bhq, bhkv, sq, sk)) return cudaErrorInvalidValue;
  const Call c = make_call(q, k, v, d_o, lse, delta, out0, out1, bhq, bhkv, sq, sk, causal,
                           window, scale, stream);
#define CASE(DH) BWD_CASE(DH, launch_dq_bf16)
  switch (dh) {
    BWD_WIDTHS(CASE)
    default:
      return cudaErrorInvalidValue;
  }
#undef CASE
}
