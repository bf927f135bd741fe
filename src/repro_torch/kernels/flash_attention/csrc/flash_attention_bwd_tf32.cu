// Flash attention backward for NVIDIA Hopper (sm_90a), fp32: the dK/dV and
// dQ passes, on the tensor cores to fp32 accuracy. Every product is taken
// as three TF32 products on mma.sync.m16n8k8 (3xTF32, the instruction path
// of the fp32 forward, flash_attention.cu), the streamed tiles come in by
// cp.async into two stages. D = rowsum(do * o), the first of the
// backward's three launches, is flash_attention_bwd.cu's; the bf16 passes
// are flash_attention_bwd_wgmma.cu's.
//
// Replaces no TPU kernel of its own: the reference's training step
// differentiates its jnp attention by autodiff and never calls the Pallas
// kernel `flash_attention_bhsd` (src/repro/kernels/flash_attention/
// kernel.py:124). It computes the function of flash_attention_bwd.cu's
// contract (kernels/flash_attention/ref.py, `attention_bwd_ref`):
//   * q (BHq, Sq, Dh), k/v (BHkv, Sk, Dh), do like q, lse and delta (BHq,
//     Sq), all fp32 and contiguous; query head h reads kv head h / (BHq /
//     BHkv); Dh in 16..128, a multiple of 16;
//   * live pairs: k_pos <= q_pos (causal), k_pos > q_pos - window (window
//     > 0), k_pos < Sk, q_pos < Sq, positions from 0 for q and k alike;
//   * P = exp(s * scale - lse) on live pairs, exactly 0 elsewhere;
//     dS = P * (do v^T - D);
//   * dV = sum over the group's query heads of P^T do, dK = the same of
//     dS^T q * scale, dQ = dS k * scale.
//
// What bounds it on this card: the operations. Five products of 2 * Dh a
// live pair (10 * Dh FLOP; the passes recompute S and do v^T in both, 14 *
// Dh in all), each as three TF32 products at the tensor cores' TF32 rate;
// one TF32 product keeps 11 bits and misses the fp32 limit (1e-4 relative
// a gradient), three keep ~22 (tests/test_torch_flash_kernel.py's
// tf32x3_bwd_model is this arithmetic in plain torch).
//
// Design. 8 warps a block, 16 rows a warp, as in the forward:
//   * dK/dV: a block owns 64 keys of one kv head, 16 a pair of warps; K and
//     V come in once. For each query head of the group in turn, and each
//     step of queries in reach of the block's keys in ascending order (64
//     rows, 32 at Dh above 64: Plan<DH>::BS), Q, dO and the rows' LSE and D
//     stream through two cp.async stages. A step has two halves: the pair's dV warp takes S^T = K Q^T
//     and P^T, which it leaves in shared memory, while its dK warp takes
//     dP^T = V dO^T (the forward's S = Q K^T with the operands swapped: K
//     or V by ldmatrix as A, Q or dO by ldmatrix as B); after a barrier the
//     dV warp adds P^T dO to dV, the dK warp forms dS^T = P^T (dP^T - D)
//     and adds dS^T Q to dK (the forward's P V: the accumulator tile is
//     the A fragment, the row-major B read by 16-byte loads). Each warp
//     keeps one accumulator of 16 keys x Dh in registers: one warp with
//     both (128 registers at Dh 128) spilled at Dh 96 and up.
//   * dQ: a block owns 128 query rows of one query head; Q, dO (and each
//     lane's LSE and D, in registers) come in once, steps of K and V (64
//     keys, 32 at Dh above 64) stream through two stages. A warp's step: S = Q K^T, P,
//     dP = dO V^T, dS, dQ += dS K.
//   * grids: dK/dV (BHkv, key tiles), the low key tiles first (under a
//     causal mask they see the most rows); dQ (BHq, row tiles), the last
//     row tiles first (they see the most keys): the long blocks launch
//     first.
//   * masks as in the forward: a warp skips a step in which none of its
//     pairs is live, and masks only a step that crosses a mask's edge or
//     the ragged end of Sq or Sk; rows past Sq and keys past Sk are
//     zero-filled and their P is exactly 0.
//   * S and dP keep their small products (a_lo b_hi + a_hi b_lo) in their
//     own accumulators, so the large one takes one rounding a k-step; dK,
//     dV and dQ take each step's products in fresh accumulators and add
//     them to theirs with a rounded fp32 add, since the tensor core rounds
//     every mma's sum toward zero (product_pb).
//   * P in base 2: 2^(s * scale * log2 e - lse * log2 e) by ex2.
// No block adds into another's output and every sum runs in a fixed order
// (dK/dV over the group's heads in order): two runs give the same bits.
//
// Shared memory a block (Plan<DH>): rows padded to Dh + 4 floats (no bank
// conflicts in ldmatrix or the 16-byte loads); at Dh 128 the dK/dV pass
// takes 2 x 64 rows resident, 2 x 2 x 32 streamed and 8 KB of P^T
// (143,872 bytes), the dQ pass 2 x 128 and 2 x 2 x 32 (202,752 bytes),
// below the 232,448 an H100 block may opt in to. flash_bwd_f32_smem_bytes
// reports them to the host.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3, beside the other
// flash sources into one library (kernels/flash_attention/_build.py); the
// PTX helpers are sm80_tf32.cuh's; entry points bound with ctypes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm80_tf32.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int BR = 16 * WARPS;  // a dQ block's query rows
constexpr int PAIRS = WARPS / 2;
constexpr int BKV = 16 * PAIRS;  // a dK/dV block's keys: 16 a pair of warps
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

// Shapes and the shared-memory plan of one head width (offsets in floats).
template <int DH>
struct Plan {
  static_assert(DH % 16 == 0 && DH >= 16 && DH <= 128, "head width");
  static constexpr int RS = DH + 4;  // row stride (floats): RS / 4 odd, no bank conflicts
  static constexpr int NT = DH / 8;  // n-tiles of dK, dV, dQ; k-steps of S
  static constexpr int G = DH % 32 == 0 ? 4 : 2;  // n-tiles that share a B load
  // a streamed step's query rows (dK/dV) or keys (dQ): 64 where the
  // registers allow, so that a step's barriers and copies weigh less (on
  // an H100 at hymba's shape, Dh 64: 2.93 ms, against 3.27 with 32-row
  // steps); 64-row dK/dV steps spill at Dh 96 and up
  static constexpr int BS = DH <= 64 ? 64 : 32;
  static constexpr int ST = BS / 8;  // n-tiles of a step's S^T or S, k-steps of its P products
  // dK/dV: K, V [BKV][RS] resident; Q, dO [2][BS][RS] and LSE, D [2][BS]
  // streamed; each pair's P^T [ST][32 lanes][4] for its dK warp
  static constexpr int KV_K = 0;
  static constexpr int KV_V = BKV * RS;
  static constexpr int KV_Q = 2 * BKV * RS;
  static constexpr int KV_DO = KV_Q + 2 * BS * RS;
  static constexpr int KV_P = KV_DO + 2 * BS * RS;
  static constexpr int KV_LSE = KV_P + PAIRS * ST * 32 * 4;
  static constexpr int KV_D = KV_LSE + 2 * BS;
  static constexpr int DKDV_BYTES = (KV_D + 2 * BS) * (int)sizeof(float);
  // dQ: Q, dO [BR][RS] resident; K, V [2][BS][RS] streamed
  static constexpr int Q_Q = 0;
  static constexpr int Q_DO = BR * RS;
  static constexpr int Q_K = 2 * BR * RS;
  static constexpr int Q_V = Q_K + 2 * BS * RS;
  static constexpr int DQ_BYTES = (Q_V + 2 * BS * RS) * (int)sizeof(float);
};

// rows [r0, r0 + n_rows) of src (n rows of DH) into dst (stride RS) by
// 16-byte cp.async; rows past n are zero-filled. The source offsets are
// 32-bit from the first row: what a thread keeps across the steps is one
// register an offset, not a 64-bit pair.
template <int DH>
__device__ __forceinline__ void issue_rows(float* dst, const float* src, int r0, int n_rows,
                                           int n) {
  constexpr int NV = DH / 4;
  const float* first = src + (size_t)r0 * DH;
  for (int i = threadIdx.x; i < n_rows * NV; i += THREADS) {
    const int r = i / NV, c = 4 * (i % NV);
    const bool live = r0 + r < n;
    cp_async16(dst + r * Plan<DH>::RS + c, live ? first + (r * DH + c) : src, live ? 16 : 0);
  }
}

// hi + lo (16 x BS) = A B^T in three TF32 products a pair of fragments, the
// small ones (a_lo b_hi + a_hi b_lo) in lo: A is the warp's 16 rows of a
// [.][RS] tile, `a` this lane's ldmatrix address into it (row
// (l % 8) + 8 ((l / 8) % 2), dims + 4 (l / 16)); B the BS rows of DH at b,
// `bo` this lane's ldmatrix offset (row l % 8 of an n-tile, dims + 4 (l / 8):
// two k-steps a load).
template <int DH>
__device__ __forceinline__ void product_abt(float (&hi)[Plan<DH>::ST][4],
                                            float (&lo)[Plan<DH>::ST][4], const float* a,
                                            const float* b, int bo) {
  constexpr int RS = Plan<DH>::RS, ST = Plan<DH>::ST;
#pragma unroll
  for (int j = 0; j < ST; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) hi[j][e] = lo[j][e] = 0.f;
#pragma unroll
  for (int kp = 0; kp < DH / 16; ++kp) {  // k-steps 2kp, 2kp + 1
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t x[4];
      ldsm_x4(a + 16 * kp + 8 * h, x);
#pragma unroll
      for (int e = 0; e < 4; ++e) split(__uint_as_float(x[e]), ah[h][e], al[h][e]);
    }
#pragma unroll
    for (int j = 0; j < ST; ++j) {
      uint32_t x[4], bh[4], bl[4];
      ldsm_x4(b + 8 * j * RS + bo + 16 * kp, x);
#pragma unroll
      for (int e = 0; e < 4; ++e) split(__uint_as_float(x[e]), bh[e], bl[e]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mma_tf32(lo[j], al[h], bh[2 * h], bh[2 * h + 1]);
        mma_tf32(lo[j], ah[h], bl[2 * h], bl[2 * h + 1]);
        mma_tf32(hi[j], ah[h], bh[2 * h], bh[2 * h + 1]);
      }
    }
  }
}

// acc (16 x DH) += P B in three TF32 products: P (16 x BS) in the
// accumulator layout (k-step kk is P's n-tile kk, its columns in the order
// 0, 2, 4, 6, 1, 3, 5, 7), B the BS rows of DH at b (row-major, stride RS),
// read in the same order (b0 from row 2t, b1 from row 2t + 1) by 4G-byte
// loads: within a group of G n-tiles, column g of n-tile i is dim G g + i,
// so lane (g, t) ends with dims 8 G grp + 2 G t + [0, 2 G) of its rows.
// The step's products go into fresh accumulators, G n-tiles at a time,
// which a rounded fp32 add then adds to acc: the tensor core rounds each
// mma's sum toward zero, and over the thousands of k-steps a long row of
// dK or dV sums (mixtral: 6 heads x 4096 rows) that bias, taken in acc
// itself, reached 1.8e-4 of the gradient, past the 1e-4 limit.
template <int DH>
__device__ __forceinline__ void product_pb(float (&acc)[Plan<DH>::NT][4],
                                           const float (&p)[Plan<DH>::ST][4], const float* b,
                                           int g, int t) {
  constexpr int RS = Plan<DH>::RS, NT = Plan<DH>::NT, G = Plan<DH>::G, ST = Plan<DH>::ST;
  using V = Vec<G>;
  const float* b0 = b + 2 * t * RS + G * g;
#pragma unroll
  for (int grp = 0; grp < NT / G; ++grp) {
    float d[G][4];
#pragma unroll
    for (int i = 0; i < G; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < ST; ++kk) {
      // P's fragments split anew for each group: registers, not issue
      // slots, are what the dK/dV pass runs short of
      uint32_t ph[4], pl[4];
      split(p[kk][0], ph[0], pl[0]);
      split(p[kk][2], ph[1], pl[1]);
      split(p[kk][1], ph[2], pl[2]);
      split(p[kk][3], ph[3], pl[3]);
      const float* row = b0 + 8 * kk * RS + 8 * G * grp;
      const typename V::T x0 = *reinterpret_cast<const typename V::T*>(row);
      const typename V::T x1 = *reinterpret_cast<const typename V::T*>(row + RS);
#pragma unroll
      for (int i = 0; i < G; ++i) {
        uint32_t b0h, b0l, b1h, b1l;
        split(V::at(x0, i), b0h, b0l);
        split(V::at(x1, i), b1h, b1l);
        mma_tf32(d[i], pl, b0h, b1h);
        mma_tf32(d[i], ph, b0l, b1l);
        mma_tf32(d[i], ph, b0h, b1h);
      }
    }
#pragma unroll
    for (int i = 0; i < G; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[G * grp + i][e] += d[i][e];
  }
}

// rows row0 + g and row0 + g + 8 of acc * scale (the layout product_pb
// leaves) into out (rows of DH); rows at or past n are not written
template <int DH>
__device__ __forceinline__ void store_rows(float* out, const float (&acc)[Plan<DH>::NT][4],
                                           int row0, int n, float scale, int g, int t) {
  constexpr int NT = Plan<DH>::NT, G = Plan<DH>::G;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= n) continue;
    float* orow = out + (size_t)row * DH;
#pragma unroll
    for (int grp = 0; grp < NT / G; ++grp) {
      float o[2 * G];
#pragma unroll
      for (int i = 0; i < G; ++i) {
        o[i] = acc[G * grp + i][2 * r] * scale;
        o[G + i] = acc[G * grp + i][2 * r + 1] * scale;
      }
      float4* dst = reinterpret_cast<float4*>(orow + 8 * G * grp + 2 * G * t);
#pragma unroll
      for (int c = 0; c < G / 2; ++c)
        dst[c] = make_float4(o[4 * c], o[4 * c + 1], o[4 * c + 2], o[4 * c + 3]);
    }
  }
}

// step `it` of a dK/dV block (query head it / n_tiles of the group, rows
// from (t0 + it % n_tiles) * BS) into stage `stage`: Q, dO by 16-byte
// copies, the rows' LSE and D by 4-byte ones; rows past Sq are zeros
template <int DH>
__device__ __forceinline__ void issue_step(float* smem, const float* q, const float* d_o,
                                           const float* lse, const float* delta, int bh, int q0,
                                           int sq, int stage) {
  using P = Plan<DH>;
  constexpr int BS = P::BS;
  issue_rows<DH>(smem + P::KV_Q + stage * BS * P::RS, q + (size_t)bh * sq * DH, q0, BS, sq);
  issue_rows<DH>(smem + P::KV_DO + stage * BS * P::RS, d_o + (size_t)bh * sq * DH, q0, BS, sq);
  if (threadIdx.x < 2 * BS) {
    const int r = threadIdx.x % BS, row = q0 + r;
    const bool is_d = threadIdx.x >= BS, live = row < sq;
    const float* src = is_d ? delta : lse;
    cp_async4(smem + (is_d ? P::KV_D : P::KV_LSE) + stage * BS + r,
              live ? src + (size_t)bh * sq + row : src, live ? 4 : 0);
  }
}

// The dK/dV pass. grid (BHkv, ceil(Sk / BKV)), THREADS threads,
// Plan<DH>::DKDV_BYTES of dynamic shared memory. Warp w of the pair w % 4
// owns its pair's 16 keys: warps 0-3 take S^T = K Q^T, P^T and dV, warps
// 4-7 dP^T = V dO^T, dS^T and dK, each one accumulator of 16 keys x DH
// (dK and dV in one warp spill at Dh 96 and up); the dV warp hands P^T to
// its dK warp through shared memory between a step's two barriers.
template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
bwd_dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ d_o,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dk, float* __restrict__ dv, int sq, int sk, int group,
                    int causal, int window, float scale) {
  using P = Plan<DH>;
  constexpr int RS = P::RS, NT = P::NT, BS = P::BS, ST = P::ST;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int pair = warp % PAIRS;
  const bool dk_warp = warp >= PAIRS;
  const int bkv = blockIdx.x, k0 = blockIdx.y * BKV;  // low key tiles (most rows) first
  const Mask mask{sq, sk, causal, window};
  // the query tiles in reach of the block's keys, for each head of the group
  int q_lo, q_hi;
  mask.rows(k0, min(k0 + BKV, sk), q_lo, q_hi);
  const int t0 = q_lo / BS, n_tiles = q_lo < q_hi ? (q_hi + BS - 1) / BS - t0 : 0;
  const int steps = group * n_tiles;

  issue_rows<DH>(smem + P::KV_K, k + (size_t)bkv * sk * DH, k0, BKV, sk);
  issue_rows<DH>(smem + P::KV_V, v + (size_t)bkv * sk * DH, k0, BKV, sk);
  if (steps > 0) issue_step<DH>(smem, q, d_o, lse, delta, bkv * group, t0 * BS, sq, 0);
  cp_async_commit();

  const int kw0 = k0 + 16 * pair;  // the pair's first key
  const float sl2 = scale * LOG2E;
  // ldmatrix addresses: the A fragments of the pair's keys in K (dV warp)
  // or V (dK warp), and the offset of the B fragments of Q or dO in a tile
  const float* a = smem + (dk_warp ? P::KV_V : P::KV_K) +
                   (16 * pair + (lane & 7) + 8 * ((lane >> 3) & 1)) * RS + 4 * (lane >> 4);
  const int bo = (lane & 7) * RS + 4 * (lane >> 3);
  // P^T of the pair, [ST][32 lanes] float4s: each lane's own elements
  float4* p_x = reinterpret_cast<float4*>(smem + P::KV_P) + pair * ST * 32 + lane;

  float acc[NT][4];  // dV (dV warp) or dK (dK warp) of the pair's keys
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int it = 0; it < steps; ++it) {
    const int stage = it & 1;
    cp_async_wait_all();
    __syncthreads();  // this step is in for all; all are done with the other stage and P^T
    if (it + 1 < steps) {
      const int nx = it + 1;
      issue_step<DH>(smem, q, d_o, lse, delta, bkv * group + nx / n_tiles,
                     (t0 + nx % n_tiles) * BS, sq, stage ^ 1);
      cp_async_commit();
    }
    const int q0 = (t0 + it % n_tiles) * BS;
    // none of the pair's pairs live: keys past Sk, rows all before its
    // first key, or all past the window of its last
    const bool idle = kw0 >= sk || (causal && q0 + BS - 1 < kw0) ||
                      (window > 0 && q0 >= kw0 + 15 + window);
    const float* qs = smem + P::KV_Q + stage * BS * RS;
    const float* dos = smem + P::KV_DO + stage * BS * RS;

    // S^T (dV warp) or dP^T (dK warp), 16 keys x BS rows: lane (g, t)
    // holds keys kw0 + g (+ 8) at rows q0 + 8j + 2t (+ 1)
    float x[ST][4], x_lo[ST][4];
    if (!idle) {
      product_abt<DH>(x, x_lo, a, dk_warp ? dos : qs, bo);
      if (!dk_warp) {  // P^T, to the dK warp too
        const float* lse_s = smem + P::KV_LSE + stage * BS;
        const bool edge = q0 + BS > sq || kw0 + 16 > sk || (causal && q0 < kw0 + 15) ||
                          (window > 0 && q0 + BS - 1 >= kw0 + window);
#pragma unroll
        for (int j = 0; j < ST; ++j) {
          const float2 l2 = *reinterpret_cast<const float2*>(lse_s + 8 * j + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float y = ex2((x[j][e] + x_lo[j][e]) * sl2 - ((e & 1) ? l2.y : l2.x) * LOG2E);
            if (edge && !mask.live(q0 + 8 * j + 2 * t + (e & 1), kw0 + g + 8 * (e >> 1)))
              y = 0.f;
            x[j][e] = y;
          }
          p_x[32 * j] = make_float4(x[j][0], x[j][1], x[j][2], x[j][3]);
        }
      }
    }
    __syncthreads();  // P^T is in for the dK warps
    if (idle) continue;
    if (!dk_warp) {
      product_pb<DH>(acc, x, dos, g, t);  // dV += P^T dO
    } else {  // dS^T = P^T (dP^T - D); dK += dS^T Q
      const float* d_s = smem + P::KV_D + stage * BS;
#pragma unroll
      for (int j = 0; j < ST; ++j) {
        const float4 p4 = p_x[32 * j];
        const float2 d2 = *reinterpret_cast<const float2*>(d_s + 8 * j + 2 * t);
        const float pj[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          x[j][e] = pj[e] * ((x[j][e] + x_lo[j][e]) - ((e & 1) ? d2.y : d2.x));
      }
      product_pb<DH>(acc, x, qs, g, t);
    }
  }
  cp_async_wait_all();  // nothing left in flight at exit

  store_rows<DH>((dk_warp ? dk : dv) + (size_t)bkv * sk * DH, acc, kw0, sk,
                 dk_warp ? scale : 1.f, g, t);
}

// The dQ pass. grid (BHq, ceil(Sq / BR)), THREADS threads,
// Plan<DH>::DQ_BYTES of dynamic shared memory.
template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ d_o,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  float* __restrict__ dq, int sq, int sk, int group, int causal, int window,
                  float scale) {
  using P = Plan<DH>;
  constexpr int RS = P::RS, NT = P::NT, BS = P::BS, ST = P::ST;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, bkv = bh / group;
  const int q0 = (gridDim.y - 1 - (int)blockIdx.y) * BR;  // longest rows first
  const Mask mask{sq, sk, causal, window};
  const float* kh = k + (size_t)bkv * sk * DH;
  const float* vh = v + (size_t)bkv * sk * DH;
  // the key tiles in reach of the block's rows
  int k_lo, k_hi;
  mask.keys(q0, min(q0 + BR, sq), k_lo, k_hi);
  const int t0 = k_lo / BS, steps = k_lo < k_hi ? (k_hi + BS - 1) / BS - t0 : 0;

  issue_rows<DH>(smem + P::Q_Q, q + (size_t)bh * sq * DH, q0, BR, sq);
  issue_rows<DH>(smem + P::Q_DO, d_o + (size_t)bh * sq * DH, q0, BR, sq);
  if (steps > 0) {
    issue_rows<DH>(smem + P::Q_K, kh, t0 * BS, BS, sk);
    issue_rows<DH>(smem + P::Q_V, vh, t0 * BS, BS, sk);
  }
  cp_async_commit();

  const int w0 = q0 + 16 * warp;  // this warp's first row
  const float sl2 = scale * LOG2E;
  // this lane's rows w0 + g, w0 + g + 8: LSE in base 2, and D
  float lse2[2], dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w0 + g + 8 * r;
    lse2[r] = row < sq ? lse[(size_t)bh * sq + row] * LOG2E : 0.f;
    dr[r] = row < sq ? delta[(size_t)bh * sq + row] : 0.f;
  }
  const int a_row = (16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1)) * RS + 4 * (lane >> 4);
  const float* qa = smem + P::Q_Q + a_row;
  const float* doa = smem + P::Q_DO + a_row;
  const int bo = (lane & 7) * RS + 4 * (lane >> 3);

  float dq_acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[n][e] = 0.f;

  for (int it = 0; it < steps; ++it) {
    const int stage = it & 1;
    cp_async_wait_all();
    __syncthreads();  // this tile is in for all; all are done with the other stage
    if (it + 1 < steps) {
      issue_rows<DH>(smem + P::Q_K + (stage ^ 1) * BS * RS, kh, (t0 + it + 1) * BS, BS, sk);
      issue_rows<DH>(smem + P::Q_V + (stage ^ 1) * BS * RS, vh, (t0 + it + 1) * BS, BS, sk);
      cp_async_commit();
    }
    const int kt0 = (t0 + it) * BS;
    // none of this warp's pairs live: rows past Sq, keys all in its rows'
    // future, or all behind its first row's window
    if (w0 >= sq || (causal && kt0 > w0 + 15) || (window > 0 && kt0 + BS - 1 <= w0 - window))
      continue;
    const float* ks = smem + P::Q_K + stage * BS * RS;
    const float* vs = smem + P::Q_V + stage * BS * RS;

    // P (16 rows x BS keys): lane (g, t) holds rows w0 + g (+ 8) at keys
    // kt0 + 8j + 2t (+ 1)
    float p[ST][4], s_lo[ST][4];
    product_abt<DH>(p, s_lo, qa, ks, bo);
    const bool edge = kt0 + BS > sk || w0 + 16 > sq || (causal && kt0 + BS - 1 > w0) ||
                      (window > 0 && kt0 <= w0 + 15 - window);
#pragma unroll
    for (int j = 0; j < ST; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = ex2((p[j][e] + s_lo[j][e]) * sl2 - lse2[e >> 1]);
        if (edge && !mask.live(w0 + g + 8 * (e >> 1), kt0 + 8 * j + 2 * t + (e & 1))) x = 0.f;
        p[j][e] = x;
      }
    // dS = P (dP - D), dP = dO V^T
    float ds[ST][4], dp_lo[ST][4];
    product_abt<DH>(ds, dp_lo, doa, vs, bo);
#pragma unroll
    for (int j = 0; j < ST; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[j][e] = p[j][e] * ((ds[j][e] + dp_lo[j][e]) - dr[e >> 1]);
    product_pb<DH>(dq_acc, ds, ks, g, t);
  }
  cp_async_wait_all();  // nothing left in flight at exit

  store_rows<DH>(dq + (size_t)bh * sq * DH, dq_acc, w0, sq, scale, g, t);
}

// ------------------------------------------------------------------ host
struct Call {
  const void *q, *k, *v, *d_o, *lse, *delta;
  void *out0, *out1;
  int bhq, bhkv, sq, sk, causal, window;
  float scale;
  cudaStream_t stream;
};

// opts a kernel into `bytes` of dynamic shared memory; grid.y (the tiles)
// is at most 65535
template <typename K>
cudaError_t prepare(K kernel, int bytes, int tiles) {
  if (tiles > 65535) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int DH>
cudaError_t launch_dkdv(const Call& c) {
  auto kernel = bwd_dkdv_f32_kernel<DH>;
  constexpr int bytes = Plan<DH>::DKDV_BYTES;
  const int tiles = (c.sk + BKV - 1) / BKV;
  cudaError_t err = prepare(kernel, bytes, tiles);
  if (err != cudaSuccess || tiles == 0) return err;
  kernel<<<dim3(c.bhkv, tiles), THREADS, bytes, c.stream>>>(
      static_cast<const float*>(c.q), static_cast<const float*>(c.k),
      static_cast<const float*>(c.v), static_cast<const float*>(c.d_o),
      static_cast<const float*>(c.lse), static_cast<const float*>(c.delta),
      static_cast<float*>(c.out0), static_cast<float*>(c.out1), c.sq, c.sk, c.bhq / c.bhkv,
      c.causal, c.window, c.scale);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dq(const Call& c) {
  auto kernel = bwd_dq_f32_kernel<DH>;
  constexpr int bytes = Plan<DH>::DQ_BYTES;
  const int tiles = (c.sq + BR - 1) / BR;
  cudaError_t err = prepare(kernel, bytes, tiles);
  if (err != cudaSuccess || tiles == 0) return err;
  kernel<<<dim3(c.bhq, tiles), THREADS, bytes, c.stream>>>(
      static_cast<const float*>(c.q), static_cast<const float*>(c.k),
      static_cast<const float*>(c.v), static_cast<const float*>(c.d_o),
      static_cast<const float*>(c.lse), static_cast<const float*>(c.delta),
      static_cast<float*>(c.out0), c.sq, c.sk, c.bhq / c.bhkv, c.causal, c.window, c.scale);
  return cudaGetLastError();
}

bool valid(int bhq, int bhkv, int sq, int sk) {
  return bhq > 0 && bhkv > 0 && bhq % bhkv == 0 && sq >= 0 && sk >= 0;
}

}  // namespace

#define BWD_WIDTHS(X) X(16) X(32) X(48) X(64) X(80) X(96) X(112) X(128)

// dK into out0 and dV into out1 ((BHkv, Sk, Dh) fp32), from q, k, v, do
// (fp32, 16-byte aligned, contiguous), lse (BHq, Sq) and delta (BHq, Sq)
// fp32. window <= 0 means no window. Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for a shape the kernel does not take).
extern "C" int flash_bwd_dkdv_f32(const void* q, const void* k, const void* v, const void* d_o,
                                  const void* lse, const void* delta, void* out0, void* out1,
                                  int bhq, int bhkv, int sq, int sk, int dh, int causal,
                                  int window, float scale, void* stream) {
  if (!valid(bhq, bhkv, sq, sk)) return cudaErrorInvalidValue;
  const Call c{q,   k,    v,      d_o,    lse,   delta, out0, out1, bhq, bhkv, sq,
               sk,  causal, window, scale, static_cast<cudaStream_t>(stream)};
#define CASE(DH) \
  case DH:       \
    return launch_dkdv<DH>(c);
  switch (dh) {
    BWD_WIDTHS(CASE)
    default:
      return cudaErrorInvalidValue;
  }
#undef CASE
}

// dQ into out0 ((BHq, Sq, Dh) fp32); out1 is not read. The rest as
// flash_bwd_dkdv_f32.
extern "C" int flash_bwd_dq_f32(const void* q, const void* k, const void* v, const void* d_o,
                                const void* lse, const void* delta, void* out0, void* out1,
                                int bhq, int bhkv, int sq, int sk, int dh, int causal,
                                int window, float scale, void* stream) {
  if (!valid(bhq, bhkv, sq, sk)) return cudaErrorInvalidValue;
  const Call c{q,   k,    v,      d_o,    lse,   delta, out0, out1, bhq, bhkv, sq,
               sk,  causal, window, scale, static_cast<cudaStream_t>(stream)};
#define CASE(DH) \
  case DH:       \
    return launch_dq<DH>(c);
  switch (dh) {
    BWD_WIDTHS(CASE)
    default:
      return cudaErrorInvalidValue;
  }
#undef CASE
}

// The dynamic shared memory a block of head width dh launches with: the
// dQ pass's if dq, else the dK/dV pass's (0 for a width the kernels do not
// take).
extern "C" int flash_bwd_f32_smem_bytes(int dh, int dq) {
#define BYTES(DH) \
  case DH:        \
    return dq ? Plan<DH>::DQ_BYTES : Plan<DH>::DKDV_BYTES;
  switch (dh) {
    BWD_WIDTHS(BYTES)
    default:
      return 0;
  }
#undef BYTES
}
