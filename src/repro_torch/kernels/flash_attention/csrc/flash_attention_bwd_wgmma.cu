// Flash attention backward on Hopper's tensor cores (sm_90a), for bf16:
// dK/dV and dQ of the function that flash_attention_wgmma.cu computes, from
// q, k, v, the output's gradient do, the rows' log-sum-exp (LSE) that the
// forward emits and D = rowsum(do * o) (flash_bwd_pre_bf16 of
// flash_attention_bwd.cu). wgmma for every product, tiles by TMA into an
// mbarrier ring, one producer warpgroup and two consumer warpgroups: the
// forward's shape.
//
// Replaces no TPU kernel of its own: the reference's training step
// differentiates its jnp attention (src/repro/models/attention.py,
// `attention_chunked`) by autodiff and never calls the Pallas kernel
// `flash_attention_bhsd` (src/repro/kernels/flash_attention/kernel.py:124),
// whose gradient this is. It computes what `attention_bwd_ref`
// (kernels/flash_attention/ref.py) computes:
//   * q (BHq, Sq, Dh), k/v (BHkv, Sk, Dh), do like q, bf16, lse and D
//     (BHq, Sq) fp32, all contiguous; query head h reads kv head
//     h / (BHq / BHkv); Dh in 16..128, a multiple of 16;
//   * live pairs: k_pos <= q_pos (causal), k_pos > q_pos - window (window
//     > 0), k_pos < Sk, q_pos < Sq, positions from 0 for q and k alike;
//   * P = exp(s * scale - lse) on live pairs, 0 elsewhere; dS = P (do v^T - D);
//   * dV = sum over the group's query heads of P^T do, dK = the same of
//     dS^T q * scale, dQ = dS k * scale.
// P^T and dS^T are rounded to bf16 as the A operands of dV and dK, and dS
// as that of dQ (a relative 2^-9 a term, as every tensor-core flash kernel
// does); the products q.k and do.v are exact in fp32.
//
// Two passes, no atomics: a dK/dV block owns 128 keys of one kv head and
// sums over the group's query heads itself; a dQ block owns 128 query rows
// of one query head. No block adds into another's output and every sum
// runs in one fixed order (group heads ascending, then row or key tiles
// ascending, then k-steps), so equal inputs give equal bits.
//
// What bounds it: 10 Dh FLOP a live pair (five products of 2 Dh; s and
// do.v are recomputed in both passes, 14 Dh in all). Causal at Sq = Sk =
// 4096 that is ~1,280 FLOP a byte of q, k, v, o, do and the gradients, far
// above the H100's ~295: the bound is the operations at the bf16
// tensor-core rate. The design goes for that rate:
//   * every product on wgmma (m64nNk16, bf16 in, fp32 accumulators in
//     registers); each consumer warpgroup owns 64 rows of the block's 128
//     (keys in dK/dV, query rows in dQ);
//   * a tile is loaded once by TMA in the 128-byte swizzle and read in both
//     orientations through its descriptor: as a K-major operand (S^T = K
//     Q^T, dP^T = V dO^T, S = Q K^T, dP = dO V^T) and as the MN-major B of
//     the products along the other axis (dV += P^T dO, dK += dS^T Q, dQ +=
//     dS K). Nothing is transposed by hand;
//   * P^T and dS^T (dS in dQ) are formed on the accumulator fragment and
//     rounded into A fragments in registers: an m64 x k16 A fragment is two
//     n8 blocks of the accumulator, so no shared memory is touched; in dQ,
//     P forms while dP's product runs (in dK/dV that overlap measured no
//     faster: the other warpgroup's products already fill the gap);
//   * warpgroup 0's first thread keeps TMA loads in flight, STAGES deep, while
//     the consumers compute; setmaxnreg moves registers from it (24 a
//     thread) to the consumers (240), whose dK/dV accumulators alone take
//     128;
//   * only the steps on a diagonal, at a window edge or at a ragged end run
//     the masked arithmetic; a warpgroup skips the steps none of its pairs
//     reach (it still takes its turn on the ring's barriers);
//   * the dQ grid launches its longest rows first, as the forward does; the
//     dK/dV grid's first key tiles are already the causal pass's heaviest.
// Head widths below 64 and between 64 and 128 are padded to 64 and 128 by
// the TMA box: columns past Dh are zeros, add nothing, and are not stored.
// Rows past Sq and keys past Sk arrive as zeros (3-d tensor maps: the fill
// is per head), and the mask gives their pairs P = 0. A dK/dV step's
// -LSE log2(e) and D (one a row) are written into its stage by 64 threads
// of the producer warpgroup, which then arrive on the stage's barrier
// beside the TMA bytes of its Q and dO tiles.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3, compiled beside the
// forward sources and flash_attention_bwd.cu into one library
// (kernels/flash_attention/_build.py); the PTX helpers and the host's tensor
// maps are in sm90.cuh. Entries flash_bwd_dkdv_bf16 and flash_bwd_dq_bf16,
// bound with ctypes.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int THREADS = 384;  // warpgroup 0 loads, warpgroups 1 and 2 compute
constexpr int CONSUMERS = THREADS - 128;
constexpr int BKV = 128;      // dK/dV: a block's keys, 64 a consumer warpgroup
constexpr int BR = 64;        // dK/dV: a step's query rows
constexpr int KV_STAGES = 2;  // dK/dV: depth of the Q/dO ring
constexpr int BQ = 128;       // dQ: a block's query rows, 64 a consumer warpgroup
constexpr int BK = 128;       // dQ: a step's keys
constexpr int Q_STAGES = 2;   // dQ: depth of the K/V ring
constexpr float LOG2E = 1.4426950408889634f;
constexpr int FAR = 1 << 30;  // an offset no tile reaches

// The live pairs' reach along each axis.
struct Mask {
  int sq, sk, causal, window;

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

// ------------------------------------------------- consumer building blocks
// The accumulator fragment of m64nN: thread (warp w, lane l) of a warpgroup
// holds rows r = 16w + l/4 and r + 8, columns 8j + cq and 8j + cq + 1
// (cq = 2 (l % 4)) of every n8 block j, in registers 4j + 2i + e (row
// r + 8i, column 8j + cq + e).

// issue D (64 x N) = A B^T over the padded head width (not waited for): A
// is 64 rows of a tile whose 64-column panels lie A_PANEL bytes apart, B is
// N rows of one whose panels lie B_PANEL bytes apart, both K-major; a k16
// step advances 32 bytes along the swizzled rows, 4 steps make a panel
template <int DHP, int N, int A_PANEL, int B_PANEL>
__device__ __forceinline__ void issue_ss(float (&d)[N / 2], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < DHP / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    const uint64_t da = sw128_desc(a + (kk / 4) * A_PANEL + off, 16, ATOM_BYTES);
    const uint64_t db = sw128_desc(b + (kk / 4) * B_PANEL + off, 16, ATOM_BYTES);
    if constexpr (N == 64) {
      wgmma_ss_n64(d, da, db, kk > 0);
    } else {
      wgmma_ss_n128(d, da, db, kk > 0);
    }
  }
}

// issue D (64 x DHP) += A B (not waited for): A (64 x K) from registers,
// K / 16 k-steps; B is the K rows of a tile (rows x DHP, MN-major) whose
// 64-column panels lie B_PANEL bytes apart, 16 rows of 128 bytes a k-step
template <int DHP, int K, int B_PANEL>
__device__ __forceinline__ void issue_rs(float (&d)[DHP / 2], const uint32_t (&a)[K / 16][4],
                                         uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const uint64_t db = sw128_desc(b + kk * 16 * ROW_BYTES, B_PANEL, ATOM_BYTES);
    if constexpr (DHP == 64) {
      wgmma_rs_n64(d, a[kk], db);
    } else {
      wgmma_rs_n128(d, a[kk], db);
    }
  }
}

// an accumulator fragment (64 x N) rounded to bf16 in the A layout of m64 x
// k16: columns 16kk .. 16kk + 15 are the n8 blocks 2kk and 2kk + 1
template <int N>
__device__ __forceinline__ void pack_a(const float (&x)[N / 2], uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a[kk][0] = pack_bf16x2(x[8 * kk + 0], x[8 * kk + 1]);
    a[kk][1] = pack_bf16x2(x[8 * kk + 2], x[8 * kk + 3]);
    a[kk][2] = pack_bf16x2(x[8 * kk + 4], x[8 * kk + 5]);
    a[kk][3] = pack_bf16x2(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = 0.f;
}

// Where the live pairs fall among this thread's elements of a tile:
// element (i, j, e) sits at offset o = 8j + e along the tile's columns and
// is live when lo[i] <= o < hi[i].
struct Live {
  int lo[2], hi[2];
};

// P^T and dS^T in place of S^T and dP^T (64 keys x BR rows). Element (i, j,
// e) is key kr + 8i against row r0 + cq + 8j + e; nlse (-LSE log2(e)) and
// delta point at the step's row r0 + cq (MASKED steps only test the pairs).
template <bool MASKED>
__device__ __forceinline__ void dkdv_p_ds(float (&st)[BR / 2], float (&dpt)[BR / 2],
                                          const float* nlse, const float* delta, const Live& live,
                                          float scale_log2) {
#pragma unroll
  for (int j = 0; j < BR / 8; ++j) {
    const float2 l = *reinterpret_cast<const float2*>(nlse + 8 * j);
    const float2 d = *reinterpret_cast<const float2*>(delta + 8 * j);
    const float nl[2] = {l.x, l.y}, dd[2] = {d.x, d.y};
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = 4 * j + 2 * i + e;
        float p = fast_exp2(fmaf(st[n], scale_log2, nl[e]));
        if constexpr (MASKED) {
          const int o = 8 * j + e;  // a constant once the loops unroll
          p = (o >= live.lo[i] && o < live.hi[i]) ? p : 0.f;
        }
        st[n] = p;
        dpt[n] = p * (dpt[n] - dd[e]);
      }
  }
}

// P in place of S (64 rows x BK keys): element (i, j, e) is row r + 8i
// against key k0 + cq + 8j + e; nl[i] = -lse * log2(e) of the row
template <bool MASKED>
__device__ __forceinline__ void dq_p(float (&sc)[BK / 2], const float (&nl)[2], const Live& live,
                                     float scale_log2) {
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = 4 * j + 2 * i + e;
        float p = fast_exp2(fmaf(sc[n], scale_log2, nl[i]));
        if constexpr (MASKED) {
          const int o = 8 * j + e;
          p = (o >= live.lo[i] && o < live.hi[i]) ? p : 0.f;
        }
        sc[n] = p;
      }
}

// dS = P (dP - D) in place of dP; dd[i] = D of row r + 8i
__device__ __forceinline__ void dq_ds(const float (&p)[BK / 2], float (&dp)[BK / 2],
                                      const float (&dd)[2]) {
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = 4 * j + 2 * i + e;
        dp[n] = p[n] * (dp[n] - dd[i]);
      }
}

// ------------------------------------------------------------ dK/dV pass
// Shared memory of a dK/dV block, in bytes from a 1024-byte aligned base:
// the K and V tiles (BKV rows), KV_STAGES Q and dO tiles (BR rows; each
// tile NP panels of rows x 128 bytes), KV_STAGES -LSE log2(e) and D vectors
// (BR floats), then the mbarriers.
template <int DHP>
struct DkdvSmem {
  static constexpr int NP = DHP / PANEL;
  static constexpr int KV_PANEL = BKV * ROW_BYTES, KV_BYTES = NP * KV_PANEL;
  static constexpr int ROW_PANEL = BR * ROW_BYTES, ROWS_BYTES = NP * ROW_PANEL;
  static constexpr int VEC_BYTES = BR * 4;
  static constexpr int K0 = 0, V0 = KV_BYTES, Q0 = 2 * KV_BYTES;
  static constexpr int DO0 = Q0 + KV_STAGES * ROWS_BYTES;
  static constexpr int LSE0 = DO0 + KV_STAGES * ROWS_BYTES;
  static constexpr int D0 = LSE0 + KV_STAGES * VEC_BYTES;
  static constexpr int BARS = D0 + KV_STAGES * VEC_BYTES;  // kv_full, full[], empty[]
  static constexpr int STAGE_TX = 2 * ROWS_BYTES;  // the TMA bytes of a stage
  static constexpr int BYTES = BARS + 8 * (1 + 2 * KV_STAGES) + 1024;  // + slack to align
};

// grid (ceil(Sk / BKV), BHkv), THREADS threads, DkdvSmem<DHP>::BYTES of
// dynamic shared memory. DHP: Dh padded to 64 or 128. Consumer warpgroup c
// owns keys k0 + 64c .. + 63 and holds their dK and dV; a step is BR query
// rows of one query head, the group's heads in turn.
template <int DHP>
__global__ void __launch_bounds__(THREADS, 1)
bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
                      const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int sq, int sk, int dh, int group,
                      int causal, int window, float scale) {
  using L = DkdvSmem<DHP>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;  // the swizzle's period
  uint8_t* gbase = smem_raw + (base - smem_addr(smem_raw));
  const uint32_t kv_full = base + L::BARS;
  auto full = [&](int s) { return base + L::BARS + 8u * (1 + s); };
  auto empty = [&](int s) { return base + L::BARS + 8u * (1 + KV_STAGES + s); };

  const int k0 = blockIdx.x * BKV, bkv = blockIdx.y;
  const Mask mask{sq, sk, causal, window};
  // the row tiles that some key of the block sees, for each head of the group
  int r_lo, r_hi;
  mask.rows(k0, min(k0 + BKV, sk), r_lo, r_hi);
  const int t_begin = r_lo / BR, tiles = r_hi > r_lo ? (r_hi + BR - 1) / BR - t_begin : 0;
  const int steps = group * tiles;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < KV_STAGES; ++s) {
      mbar_init(full(s), 1 + BR);      // the TMA thread's expect_tx, the row threads
      mbar_init(empty(s), CONSUMERS);  // every consumer thread
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ------------------------------------------------ producer warpgroup
    reg_dealloc<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_full, 2 * L::KV_BYTES);
      for (int p = 0; p < L::NP; ++p) {
        tma_load_3d(base + L::K0 + p * L::KV_PANEL, &tm_k, kv_full, p * PANEL, k0, bkv);
        tma_load_3d(base + L::V0 + p * L::KV_PANEL, &tm_v, kv_full, p * PANEL, k0, bkv);
      }
      for (int it = 0; it < steps; ++it) {
        const int s = it % KV_STAGES;
        const int bh = bkv * group + it / tiles, r0 = (t_begin + it % tiles) * BR;
        mbar_wait(empty(s), ((it / KV_STAGES) & 1) ^ 1);  // the first round passes at once
        mbar_expect_tx(full(s), L::STAGE_TX);
        for (int p = 0; p < L::NP; ++p) {
          tma_load_3d(base + L::Q0 + s * L::ROWS_BYTES + p * L::ROW_PANEL, &tm_q, full(s),
                      p * PANEL, r0, bh);
          tma_load_3d(base + L::DO0 + s * L::ROWS_BYTES + p * L::ROW_PANEL, &tm_do, full(s),
                      p * PANEL, r0, bh);
        }
      }
    } else if (threadIdx.x >= 32 && threadIdx.x < 32 + BR) {
      // a row's -LSE log2(e) and D (0 past Sq) into each step's stage
      const int t = threadIdx.x - 32;
      float* nlse_s = reinterpret_cast<float*>(gbase + L::LSE0);
      float* delta_s = reinterpret_cast<float*>(gbase + L::D0);
      for (int it = 0; it < steps; ++it) {
        const int s = it % KV_STAGES;
        const int bh = bkv * group + it / tiles, row = (t_begin + it % tiles) * BR + t;
        mbar_wait(empty(s), ((it / KV_STAGES) & 1) ^ 1);
        const size_t at = (size_t)bh * sq + row;
        nlse_s[s * BR + t] = row < sq ? -lse[at] * LOG2E : 0.f;
        delta_s[s * BR + t] = row < sq ? delta[at] : 0.f;
        mbar_arrive(full(s));
      }
    }
  } else {
    // ----------------------------------------------- consumer warpgroups
    reg_alloc<240>();
    const int c = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int kc0 = k0 + 64 * c;                // this warpgroup's first key
    const int kr = kc0 + 16 * warp + lane / 4;  // keys kr and kr + 8: the fragment's rows
    const int cq = 2 * (lane % 4);
    const uint32_t k_rows = base + L::K0 + c * 64 * ROW_BYTES;
    const uint32_t v_rows = base + L::V0 + c * 64 * ROW_BYTES;
    int wr_lo, wr_hi;  // the rows that see some key of this warpgroup
    mask.rows(kc0, min(kc0 + 64, sk), wr_lo, wr_hi);
    const float scale_log2 = scale * LOG2E;

    float dk_acc[DHP / 2], dv_acc[DHP / 2];
    zero(dk_acc);
    zero(dv_acc);
    float st[BR / 2], dpt[BR / 2];
    uint32_t pa[BR / 16][4], da[BR / 16][4];

    mbar_wait(kv_full, 0);
    for (int it = 0; it < steps; ++it) {
      const int s = it % KV_STAGES;
      const int r0 = (t_begin + it % tiles) * BR;
      mbar_wait(full(s), (it / KV_STAGES) & 1);
      if (kc0 < sk && r0 < wr_hi && r0 + BR > wr_lo) {
        const uint32_t q_tile = base + L::Q0 + s * L::ROWS_BYTES;
        const uint32_t do_tile = base + L::DO0 + s * L::ROWS_BYTES;
        wgmma_fence();
        issue_ss<DHP, BR, L::KV_PANEL, L::ROW_PANEL>(st, k_rows, q_tile);    // S^T = K Q^T
        issue_ss<DHP, BR, L::KV_PANEL, L::ROW_PANEL>(dpt, v_rows, do_tile);  // dP^T = V dO^T
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(st);
        fence_regs(dpt);
        const float* nlse_s =
            reinterpret_cast<const float*>(gbase + L::LSE0 + s * L::VEC_BYTES) + cq;
        const float* delta_s =
            reinterpret_cast<const float*>(gbase + L::D0 + s * L::VEC_BYTES) + cq;
        // only steps that reach past Sq or Sk, past a key's diagonal or
        // behind a row's window test the pairs
        if (r0 + BR > sq || kc0 + 64 > sk || (causal && kc0 + 63 > r0) ||
            (window > 0 && kc0 <= r0 + BR - 1 - window)) {
          Live live;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int key = kr + 8 * i, b = key - r0 - cq;  // row r0 + cq + o: o = row - key + b
            live.lo[i] = causal ? b : -FAR;
            live.hi[i] = key >= sk ? -FAR : min(sq - r0 - cq, window > 0 ? b + window : FAR);
          }
          dkdv_p_ds<true>(st, dpt, nlse_s, delta_s, live, scale_log2);
        } else {
          dkdv_p_ds<false>(st, dpt, nlse_s, delta_s, Live{}, scale_log2);
        }
        pack_a<BR>(st, pa);
        pack_a<BR>(dpt, da);
        fence_regs(dv_acc);
        fence_regs(dk_acc);
        wgmma_fence();
        issue_rs<DHP, BR, L::ROW_PANEL>(dv_acc, pa, do_tile);  // dV += P^T dO
        issue_rs<DHP, BR, L::ROW_PANEL>(dk_acc, da, q_tile);   // dK += dS^T Q
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dv_acc);
        fence_regs(dk_acc);
      }
      mbar_arrive(empty(s));  // this thread is done with the stage
    }

    // dK (times the scale) and dV of keys below Sk, columns below Dh; every
    // key is written, zeros where no row sees it
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = kr + 8 * i;
      if (key >= sk) continue;
      const size_t row = ((size_t)bkv * sk + key) * dh;
#pragma unroll
      for (int j = 0; j < DHP / 8; ++j) {
        const int col = 8 * j + cq;
        if (col < dh) {
          *reinterpret_cast<__nv_bfloat162*>(dk + row + col) =
              __floats2bfloat162_rn(dk_acc[4 * j + 2 * i] * scale, dk_acc[4 * j + 2 * i + 1] * scale);
          *reinterpret_cast<__nv_bfloat162*>(dv + row + col) =
              __floats2bfloat162_rn(dv_acc[4 * j + 2 * i], dv_acc[4 * j + 2 * i + 1]);
        }
      }
    }
  }
}

// --------------------------------------------------------------- dQ pass
// Shared memory of a dQ block, in bytes from a 1024-byte aligned base: the
// Q and dO tiles (BQ rows), Q_STAGES K and V tiles (BK rows), then the
// mbarriers.
template <int DHP>
struct DqSmem {
  static constexpr int NP = DHP / PANEL;
  static constexpr int Q_PANEL = BQ * ROW_BYTES, Q_BYTES = NP * Q_PANEL;
  static constexpr int KV_PANEL = BK * ROW_BYTES, KV_BYTES = NP * KV_PANEL;
  static constexpr int Q0 = 0, DO0 = Q_BYTES, K0 = 2 * Q_BYTES;
  static constexpr int V0 = K0 + Q_STAGES * KV_BYTES;
  static constexpr int BARS = V0 + Q_STAGES * KV_BYTES;  // q_full, full[], empty[]
  static constexpr int BYTES = BARS + 8 * (1 + 2 * Q_STAGES) + 1024;
};

// grid (ceil(Sq / BQ), BHq), THREADS threads, DqSmem<DHP>::BYTES of dynamic
// shared memory. Consumer warpgroup c owns rows q0 + 64c .. + 63; a step is
// BK keys of the kv head.
template <int DHP>
__global__ void __launch_bounds__(THREADS, 1)
bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
                    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int sq,
                    int sk, int dh, int group, int causal, int window, float scale) {
  using L = DqSmem<DHP>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = base + L::BARS;
  auto full = [&](int s) { return base + L::BARS + 8u * (1 + s); };
  auto empty = [&](int s) { return base + L::BARS + 8u * (1 + Q_STAGES + s); };

  const int n_q = (sq + BQ - 1) / BQ;
  const int q0 = (n_q - 1 - (int)blockIdx.x) * BQ;  // longest rows launch first
  const int bh = blockIdx.y, bkv = bh / group;
  const Mask mask{sq, sk, causal, window};
  int k_lo, k_hi;  // the keys some row of the block sees
  mask.keys(q0, min(q0 + BQ, sq), k_lo, k_hi);
  const int t_begin = k_lo / BK, steps = k_hi > k_lo ? (k_hi + BK - 1) / BK - t_begin : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < Q_STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ------------------------------------------------ producer warpgroup
    reg_dealloc<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, 2 * L::Q_BYTES);
      for (int p = 0; p < L::NP; ++p) {
        tma_load_3d(base + L::Q0 + p * L::Q_PANEL, &tm_q, q_full, p * PANEL, q0, bh);
        tma_load_3d(base + L::DO0 + p * L::Q_PANEL, &tm_do, q_full, p * PANEL, q0, bh);
      }
      for (int it = 0; it < steps; ++it) {
        const int s = it % Q_STAGES, kt0 = (t_begin + it) * BK;
        mbar_wait(empty(s), ((it / Q_STAGES) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * L::KV_BYTES);
        for (int p = 0; p < L::NP; ++p) {
          tma_load_3d(base + L::K0 + s * L::KV_BYTES + p * L::KV_PANEL, &tm_k, full(s),
                      p * PANEL, kt0, bkv);
          tma_load_3d(base + L::V0 + s * L::KV_BYTES + p * L::KV_PANEL, &tm_v, full(s),
                      p * PANEL, kt0, bkv);
        }
      }
    }
  } else {
    // ----------------------------------------------- consumer warpgroups
    reg_alloc<240>();
    const int c = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int r = q0 + 64 * c + 16 * warp + lane / 4;  // rows r and r + 8
    const int cq = 2 * (lane % 4);
    const int wg_first = q0 + 64 * c, wg_last = min(wg_first + 63, sq - 1);
    int wk_lo = 0, wk_hi = 0;  // the keys some row of this warpgroup sees
    if (wg_first < sq) mask.keys(wg_first, wg_last + 1, wk_lo, wk_hi);
    const uint32_t q_rows = base + L::Q0 + c * 64 * ROW_BYTES;
    const uint32_t do_rows = base + L::DO0 + c * 64 * ROW_BYTES;
    const float scale_log2 = scale * LOG2E;
    float nl[2], dd[2];  // -lse * log2(e) and D of rows r, r + 8 (0 past Sq)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r + 8 * i;
      nl[i] = row < sq ? -lse[(size_t)bh * sq + row] * LOG2E : 0.f;
      dd[i] = row < sq ? delta[(size_t)bh * sq + row] : 0.f;
    }

    float dq_acc[DHP / 2];
    zero(dq_acc);
    float sc[BK / 2], dp[BK / 2];
    uint32_t da[BK / 16][4];

    mbar_wait(q_full, 0);
    for (int it = 0; it < steps; ++it) {
      const int s = it % Q_STAGES, kt0 = (t_begin + it) * BK;
      mbar_wait(full(s), (it / Q_STAGES) & 1);
      if (kt0 < wk_hi && kt0 + BK > wk_lo) {
        const uint32_t k_tile = base + L::K0 + s * L::KV_BYTES;
        const uint32_t v_tile = base + L::V0 + s * L::KV_BYTES;
        // P forms while dP's product runs
        wgmma_fence();
        issue_ss<DHP, BK, L::Q_PANEL, L::KV_PANEL>(sc, q_rows, k_tile);  // S = Q K^T
        wgmma_commit();
        issue_ss<DHP, BK, L::Q_PANEL, L::KV_PANEL>(dp, do_rows, v_tile);  // dP = dO V^T
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(sc);
        if (kt0 + BK > sk || (causal && kt0 + BK - 1 > wg_first) ||
            (window > 0 && kt0 <= wg_last - window)) {
          Live live;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int b = r + 8 * i - kt0 - cq;  // key kt0 + cq + o: o = key - row + b
            live.lo[i] = window > 0 ? b - window + 1 : -FAR;
            live.hi[i] = min(sk - kt0 - cq, causal ? b + 1 : FAR);
          }
          dq_p<true>(sc, nl, live, scale_log2);
        } else {
          dq_p<false>(sc, nl, Live{}, scale_log2);
        }
        wgmma_wait<0>();
        fence_regs(dp);
        dq_ds(sc, dp, dd);
        pack_a<BK>(dp, da);
        fence_regs(dq_acc);
        wgmma_fence();
        issue_rs<DHP, BK, L::KV_PANEL>(dq_acc, da, k_tile);  // dQ += dS K
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq_acc);
      }
      mbar_arrive(empty(s));
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r + 8 * i;
      if (row >= sq) continue;
      __nv_bfloat16* out = dq + ((size_t)bh * sq + row) * dh;
#pragma unroll
      for (int j = 0; j < DHP / 8; ++j) {
        const int col = 8 * j + cq;
        if (col < dh)
          *reinterpret_cast<__nv_bfloat162*>(out + col) =
              __floats2bfloat162_rn(dq_acc[4 * j + 2 * i] * scale, dq_acc[4 * j + 2 * i + 1] * scale);
      }
    }
  }
}

// ------------------------------------------------------------------ host
struct Call {
  const void *q, *k, *v, *d_o, *lse, *delta;
  void *out0, *out1;
  int bhq, bhkv, sq, sk, dh, causal, window;
  float scale;
  cudaStream_t stream;
};

template <int DHP>
cudaError_t launch_dkdv(const Call& c) {
  const size_t out_bytes = (size_t)c.bhkv * c.sk * c.dh * 2;
  if (c.sk == 0) return cudaSuccess;
  if (c.sq == 0) {  // no row: every sum is empty
    cudaError_t err = cudaMemsetAsync(c.out0, 0, out_bytes, c.stream);
    return err != cudaSuccess ? err : cudaMemsetAsync(c.out1, 0, out_bytes, c.stream);
  }
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  if (!encode(enc, &tm_q, c.q, c.bhq, c.sq, c.dh, BR) ||
      !encode(enc, &tm_do, c.d_o, c.bhq, c.sq, c.dh, BR) ||
      !encode(enc, &tm_k, c.k, c.bhkv, c.sk, c.dh, BKV) ||
      !encode(enc, &tm_v, c.v, c.bhkv, c.sk, c.dh, BKV))
    return cudaErrorInvalidValue;
  constexpr int bytes = DkdvSmem<DHP>::BYTES;
  auto kernel = bwd_dkdv_wgmma_kernel<DHP>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((c.sk + BKV - 1) / BKV, c.bhkv);
  kernel<<<grid, THREADS, bytes, c.stream>>>(
      tm_q, tm_k, tm_v, tm_do, static_cast<const float*>(c.lse),
      static_cast<const float*>(c.delta), static_cast<__nv_bfloat16*>(c.out0),
      static_cast<__nv_bfloat16*>(c.out1), c.sq, c.sk, c.dh, c.bhq / c.bhkv, c.causal, c.window,
      c.scale);
  return cudaGetLastError();
}

template <int DHP>
cudaError_t launch_dq(const Call& c) {
  if (c.sq == 0) return cudaSuccess;
  if (c.sk == 0)  // no key: every sum is empty
    return cudaMemsetAsync(c.out0, 0, (size_t)c.bhq * c.sq * c.dh * 2, c.stream);
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  if (!encode(enc, &tm_q, c.q, c.bhq, c.sq, c.dh, BQ) ||
      !encode(enc, &tm_do, c.d_o, c.bhq, c.sq, c.dh, BQ) ||
      !encode(enc, &tm_k, c.k, c.bhkv, c.sk, c.dh, BK) ||
      !encode(enc, &tm_v, c.v, c.bhkv, c.sk, c.dh, BK))
    return cudaErrorInvalidValue;
  constexpr int bytes = DqSmem<DHP>::BYTES;
  auto kernel = bwd_dq_wgmma_kernel<DHP>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((c.sq + BQ - 1) / BQ, c.bhq);
  kernel<<<grid, THREADS, bytes, c.stream>>>(
      tm_q, tm_k, tm_v, tm_do, static_cast<const float*>(c.lse),
      static_cast<const float*>(c.delta), static_cast<__nv_bfloat16*>(c.out0), c.sq, c.sk, c.dh,
      c.bhq / c.bhkv, c.causal, c.window, c.scale);
  return cudaGetLastError();
}

// the shapes the kernels take: grid.y (the heads) is at most 65535
bool valid(int bhq, int bhkv, int sq, int sk, int dh) {
  return bhq > 0 && bhkv > 0 && bhq % bhkv == 0 && bhq <= 65535 && sq >= 0 && sk >= 0 &&
         dh >= 16 && dh <= 128 && dh % 16 == 0;
}

}  // namespace

// dK into out0 and dV into out1 ((BHkv, Sk, Dh) bf16), from q, k, v, do
// (bf16, contiguous, 16-byte aligned), lse (BHq, Sq) and delta (BHq, Sq)
// fp32. window <= 0 means no window. Returns the
// cudaError_t of the launch (cudaErrorInvalidValue for a shape the kernel
// does not take or a tensor map the driver refuses, cudaErrorNotSupported
// without cuTensorMapEncodeTiled).
extern "C" int flash_bwd_dkdv_bf16(const void* q, const void* k, const void* v, const void* d_o,
                                   const void* lse, const void* delta, void* out0, void* out1,
                                   int bhq, int bhkv, int sq, int sk, int dh, int causal,
                                   int window, float scale, void* stream) {
  if (!valid(bhq, bhkv, sq, sk, dh)) return cudaErrorInvalidValue;
  const Call c{q, k, v, d_o, lse, delta, out0, out1, bhq, bhkv, sq, sk, dh, causal, window,
               scale, static_cast<cudaStream_t>(stream)};
  return dh <= 64 ? launch_dkdv<64>(c) : launch_dkdv<128>(c);
}

// dQ into out0 ((BHq, Sq, Dh) bf16); out1 is not read. The rest as
// flash_bwd_dkdv_bf16.
extern "C" int flash_bwd_dq_bf16(const void* q, const void* k, const void* v, const void* d_o,
                                 const void* lse, const void* delta, void* out0, void* out1,
                                 int bhq, int bhkv, int sq, int sk, int dh, int causal,
                                 int window, float scale, void* stream) {
  if (!valid(bhq, bhkv, sq, sk, dh)) return cudaErrorInvalidValue;
  const Call c{q, k, v, d_o, lse, delta, out0, out1, bhq, bhkv, sq, sk, dh, causal, window,
               scale, static_cast<cudaStream_t>(stream)};
  return dh <= 64 ? launch_dq<64>(c) : launch_dq<128>(c);
}
