// The gradient of the WKV6 recurrence (RWKV6 "Finch") for NVIDIA Hopper
// (sm_90a), fp32 or bf16 r, k, v: chunk-parallel, every product on the
// tensor cores as three TF32 mma.sync products (fp32 accuracy), every other
// sum in fp32.
//
// Replaces no TPU kernel: the Pallas kernel `wkv6_bhsn`
// (src/repro/kernels/rwkv6/kernel.py:94) is forward only, and the reference
// trains rwkv6 by jax.grad through its jnp chunked form
// (src/repro/models/rwkv6.py, wkv_chunked). This kernel computes what that
// gradient computes. Per head, with an N x N state S that maps keys to
// values, w_t = e^{logw_t}, S_0 the given state and G_t = dL/dS_t:
//   o_t = r_t S_{t-1} + (r_t . (u * k_t)) v_t,  S_t = diag(w_t) S_{t-1} + k_t^T v_t
//   G_T = dS_T (zero if none);  G_{t-1} = diag(w_t) G_t + r_t^T do_t;  dS_0 = G_0
//   h_t = S_{t-1} do_t,  f_t = G_t v_t,  e_t = do_t . v_t,  b_t = r_t . (u * k_t)
//   dr_t = h_t + (u * k_t) e_t,  dk_t = f_t + (u * r_t) e_t,  dv_t = k_t G_t + b_t do_t
//   du = sum_t (r_t * k_t) e_t  (per B·H row)
//   dlogw_t = w_t * rowsum(S_{t-1} * G_t) = D_t - k_t * f_t, where
//   D_t = rowsum(S_t * G_t) and D_{t-1} = D_t - k_t * f_t + r_t * h_t.
// Layouts: r, k, v, dout, dr, dk, dv (BH, S, N), r/k/v/dr/dk/dv in the
// input dtype, dout fp32; logw, dlogw (BH, S, N) fp32; u, du (BH, N) fp32;
// state0, dstate, dstate0 (BH, N, N) fp32, state0 and dstate may be null
// (zeros). All contiguous and 16-byte aligned; N 16, 32, 64 or 128; any S.
//
// The chunked form. A chunk holds C = 64 tokens (32 at N 128, for shared
// memory), cut into 16-token blocks. In base 2, per channel, cum[t] =
// sum_{tau <= t} logw[tau] log2(e) within the chunk, cum_ex[t] = cum[t-1]
// (0 at t = 0) and cum_end = cum[C-1]; both fall as t grows, so every
// exponent below is <= 0, and what underflows to 0 is ~0 in truth. With
// S_in, S_end the states at the chunk's ends and G_end = G at its last token:
//   S_end = 2^{cum_end} S_in + (k 2^{cum_end - cum})^T V
//   G_in  = 2^{cum_end} G_end + (r 2^{cum_ex})^T dO     (G before the chunk)
//   dA = dO V^T;  A[t,s] = sum_n r[t,n] k[s,n] 2^{cum_ex[t,n] - cum[s,n]}, s < t
//   h = 2^{cum_ex} (dO S_in^T) + intra,  f = 2^{cum_end - cum} (V G_end^T) + intra
//   dv = (k 2^{cum_end - cum}) G_end + A^T dO + b dO
//   dlogw_t = D_end - k_t f_t + sum_{s > t} (r_s h_s - k_s f_s),
//     D_end = rowsum(S_end * G_end)
// so dlogw's reverse sum starts afresh at every chunk end from the exact
// rowsum and never walks more than C tokens (run over 4096 tokens its
// rounding walk put rwkv6's w0 gradient 7.4e-4 off in fp32). The intra
// terms of tokens t in block i and s in an earlier block j factorise at a
// token between them, both factors <= 1: A's at block j's last token e_j
// (r_i 2^{cum_ex - cum[e_j]} times k_j 2^{cum[e_j] - cum}), h's at the
// token before block i (one product over all earlier tokens), f's at block
// i's last token (one over all later ones). Inside a 16-token block the
// second 8 tokens against the first factorise at the first half's last
// token: one m16n8k8 product each for A, h and f. Only pairs inside one
// 8-token half have no token between them; they run pairwise in fp32 on
// the CUDA cores (A a thread a pair over the keys, h and f by each
// output's own lane).
//
// Three passes, each a launch of its own entry point, no atomics, every sum
// in a fixed order (equal inputs give equal bits):
//   state (wkv6_bwd_state_*): one block per (head, chain), 8 warps at N 64,
//     a warp 16 keys by 32 value columns. The S chain runs forward over the
//     chunks and writes S_in of every chunk and S_T; the G chain runs
//     backward and writes G_end of every chunk and dS_0. A step takes two
//     chunks: each chunk's product goes into fresh accumulators, then into
//     the carried state with one rounded fp32 multiply-add (the 2^{cum_end}
//     decay is a scale on the CUDA cores); the next step's chunks come by
//     cp.async into the other of two stages.
//   chunk (wkv6_bwd_chunk_*): one block per (head, chunk), all chunks in
//     parallel, 8 warps (4 at N 16). Its tiles of r, k, v, dO and logw come
//     by cp.async; dA and A go to shared memory (dA in the lower triangle,
//     A^T in the upper); then each warp computes h^T, f^T and dv^T for its
//     16 keys (or value columns) and its token blocks, the states' rows
//     and columns read from the scratch straight into its fragments (S_in's
//     issued at the block's start), and writes dr, dk, dv, dlogw and its
//     share of du. Nothing else goes to device memory.
//   sum (wkv6_bwd_sum_*): du, the chunks' shares added in chunk order.
// Every product is m16n8k8 TF32 mma.sync into fp32: each operand x is split
// into hi = tf32(x) and lo = x - hi, and a product is a_lo b_hi + a_hi b_lo
// + a_hi b_hi, in that order. bf16 r, k, v are exact in TF32, so products
// with v itself as an operand skip a_hi b_lo; decayed values, dO, the
// states, dA and A are split. mma.sync rounds its sums toward zero, so no
// accumulator is carried across chunks.
//
// What bounds it on this card. At a training microbatch of rwkv6-3b (BH 40,
// S 4096, N 64, bf16 r/k/v) the call must read r, k, v, logw and dO and
// write dr, dk, dv and dlogw, 252 MB, 0.075 ms at 3.35 TB/s. Its products
// are ~1.1e10 FLOP of TF32 as three products each, 0.07 ms at the
// tensor cores' 495 TFLOP/s. The design's own traffic adds the chunk
// states (S_in, G_end: 84 MB written, then read with S_end). Measured, it
// takes ~0.65 ms (PERF.md section 6), bound by latency: pass state is a
// serial chain over the 64 chunks (~0.21 ms on 80 blocks), pass chunk runs
// two blocks of 8 warps a SM through phases separated by barriers (~0.41
// ms), with the pairwise triangles (2^x a pair and channel on the
// special-function unit) and the operands' splits on the CUDA cores.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (kernels/rwkv6/_build.py), one library with the forward
// kernels; entry points wkv6_bwd_{state,chunk,sum}_{f32,bf16}, bound with
// ctypes. The PTX helpers (cp.async, the tf32 mma.sync, ex2, the split)
// are the fp32 flash kernels' header.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "../../flash_attention/csrc/sm80_tf32.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr int BLK = 16;        // tokens a block of a chunk
constexpr int SUM_THREADS = 256;

// tokens a chunk: 64, or 32 at N 128 (pass chunk's shared memory)
template <int N>
struct Chunk {
  static constexpr int C = N == 128 ? 32 : 64;
};

// ---- fp32 or bf16 values
__device__ __forceinline__ float ldT(const float* p) { return *p; }
__device__ __forceinline__ float ldT(const __nv_bfloat16* p) {
  return __uint_as_float(static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(p)) << 16);
}
__device__ __forceinline__ void stT(float* p, float x) { *p = x; }
__device__ __forceinline__ void stT(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <typename T>
struct Exact {  // whether every value of T is exact in TF32
  static constexpr bool value = false;
};
template <>
struct Exact<__nv_bfloat16> {
  static constexpr bool value = true;
};

// ---- 3xTF32 products
struct FragA {
  uint32_t hi[4], lo[4];
};

__device__ __forceinline__ FragA split_a(float a0, float a1, float a2, float a3) {
  FragA f;
  split(a0, f.hi[0], f.lo[0]);
  split(a1, f.hi[1], f.lo[1]);
  split(a2, f.hi[2], f.lo[2]);
  split(a3, f.hi[3], f.lo[3]);
  return f;
}

// d += a b (16 x 8 x 8) as a_lo b_hi + a_hi b_lo + a_hi b_hi; b's rows t
// (b0) and t + 4 (b1) of column g, skipped a_hi b_lo where b is exact
template <bool B_EXACT>
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a, float b0, float b1) {
  uint32_t h0, h1, l0 = 0, l1 = 0;
  if constexpr (B_EXACT) {
    h0 = __float_as_uint(b0), h1 = __float_as_uint(b1);
  } else {
    split(b0, h0, l0);
    split(b1, h1, l1);
  }
  mma_tf32(d, a.lo, h0, h1);
  if constexpr (!B_EXACT) mma_tf32(d, a.hi, l0, l1);
  mma_tf32(d, a.hi, h0, h1);
}

__device__ __forceinline__ void zero(float (&d)[4]) { d[0] = d[1] = d[2] = d[3] = 0.f; }

// The pointers of every pass, and the sizes.
struct Args {
  const void *r, *k, *v;
  const float *logw, *u, *state0, *dout, *dstate;
  void *dr, *dk, *dv;
  float *dlogw, *du, *dstate0;
  // scratch: S_in of every chunk and S_T [BH][nc + 1][N][N], G_end of every
  // chunk [BH][nc][N][N], the chunks' shares of du [BH][nc][TS][N]
  float *sst, *gst, *dupart;
  int bh, seq, nc;
};

// cum over a tile's C rows in place (logw -> cum, base 2), a thread a key
// and segment: each of the THREADS / N segments scans its tokens, then adds
// the ends of the segments before it
template <int N, int C, int P, int THREADS>
__device__ __forceinline__ void cum_scan(float* L, int tid) {
  constexpr int SEGS = THREADS / N < C / 8 ? THREADS / N : C / 8, SL = C / SEGS;
  const int j = tid % N, sg = tid / N;
  const bool mine = sg < SEGS;
  if (mine) {
    float acc = 0.f;
#pragma unroll
    for (int t = SL * sg; t < SL * (sg + 1); ++t) {
      acc += L[t * P + j] * LOG2E;
      L[t * P + j] = acc;
    }
  }
  if constexpr (SEGS > 1) {
    __syncthreads();
    float off = 0.f;
    if (mine) {
      for (int q = 0; q < sg; ++q) off += L[(SL * (q + 1) - 1) * P + j];
    }
    __syncthreads();
    if (mine && sg > 0) {
#pragma unroll
      for (int t = SL * sg; t < SL * (sg + 1); ++t) L[t * P + j] += off;
    }
  }
}

// ROWS rows of COL_BYTES (a multiple of 16) from global row t0 of a head of
// `seq` rows (`head`, rows of `row_bytes`) into shared rows of `pitch`
// bytes, by THREADS threads; rows outside [0, seq) are zero-filled
template <int ROWS, int COL_BYTES, int THREADS>
__device__ __forceinline__ void copy_rows(uint8_t* dst, int pitch, const uint8_t* head,
                                          int row_bytes, int t0, int seq) {
  constexpr int PIECES = COL_BYTES / 16, TOTAL = ROWS * PIECES;
#pragma unroll
  for (int i0 = 0; i0 < TOTAL; i0 += THREADS) {
    const int i = i0 + threadIdx.x;
    if (TOTAL % THREADS == 0 || i < TOTAL) {
      const int t = i / PIECES, p = i % PIECES;
      const bool live = t0 + t >= 0 && t0 + t < seq;
      const uint8_t* src = live ? head + (size_t)(t0 + t) * row_bytes + 16 * p : head;
      cp_async16(dst + t * pitch + 16 * p, src, live ? 16 : 0);
    }
  }
}

// ---------------------------------------------------------------- pass state
// A block: one head's S (S chain) or G (G chain), all of it; warp w the
// keys [16 kt, 16 kt + 16) (kt = w % KTILES) and the value columns [CGW cg,
// CGW cg + CGW) (cg = w / KTILES); lane (g, q) = (lane / 4, lane % 4) holds
// rows 16 kt + g, + 8 and columns CGW cg + 8 nt + 2 q, + 1 (the mma
// accumulator's layout). A step takes CPS chunks (two; one at N 128, for
// registers): their products into fresh accumulators side by side, then
// the updates of the carried state in turn, the state between them written
// too. Each chunk's k (or r), logw and v (or dO) are read once, the next
// step's by cp.async into the other of two stages.
template <int N, typename T>
struct StatePlan {
  static constexpr int C = Chunk<N>::C;
  static constexpr int CGW = N <= 32 ? 16 : N == 64 ? 32 : 64, NTW = CGW / 8;  // columns a warp
  static constexpr int KTILES = N / 16, WARPS_S = KTILES * (N / CGW), THREADS = 32 * WARPS_S;
  // row pitches (elements) N + 8: fragments read (t + q, j + g) free of bank
  // conflicts
  static constexpr int XP = N + 8;
  static constexpr int X_BYTES = C * XP * (int)sizeof(T), L_BYTES = C * XP * 4;
  static constexpr int Y_BYTES = C * XP * 4;  // room for fp32 dO
  static constexpr int HALF = X_BYTES + L_BYTES + Y_BYTES;  // a chunk
  static constexpr int CPS = N == 128 ? 1 : 2;               // chunks a step
  static constexpr int STAGE = CPS * HALF, BYTES = 2 * STAGE;
  static_assert(X_BYTES % 16 == 0 && L_BYTES % 16 == 0, "16-byte stages");
};

template <int N, typename T, bool G_CHAIN>
__device__ __forceinline__ void state_chain(const Args& a, uint8_t* sm, int bh) {
  using P = StatePlan<N, T>;
  using TY = typename std::conditional<G_CHAIN, float, T>::type;  // B: dO or v
  constexpr int C = P::C, XP = P::XP, NTW = P::NTW, TH = P::THREADS, CPS = P::CPS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, q = lane % 4;
  const int j0 = 16 * (warp % P::KTILES), c0 = P::CGW * (warp / P::KTILES);
  const int nc = a.nc, seq = a.seq, steps = (nc + CPS - 1) / CPS;
  const size_t head = (size_t)bh * seq * N;
  const T* X = static_cast<const T*>(G_CHAIN ? a.r : a.k) + head;
  const TY* Y = static_cast<const TY*>(G_CHAIN ? static_cast<const void*>(a.dout) : a.v) + head;
  float st[NTW][4];  // the carried state, rows j0 + g (+ 8), columns c0 + 8 nt + 2 q (+ 1)
  const float* init = G_CHAIN ? a.dstate : a.state0;
#pragma unroll
  for (int nt = 0; nt < NTW; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = j0 + g + 8 * (e / 2), m = c0 + 8 * nt + 2 * q + e % 2;
      st[nt][e] = init ? init[((size_t)bh * N + j) * N + m] : 0.f;
    }
  }
  // the chunk a step's half takes: S forward, G backward (past either end a
  // chunk of zero rows, which leaves the state as it is)
  auto chunk_at = [&](int step, int h) {
    return G_CHAIN ? nc - 1 - CPS * step - h : CPS * step + h;
  };
  auto issue = [&](uint8_t* stage, int step) {
#pragma unroll
    for (int h = 0; h < CPS; ++h) {
      uint8_t* dst = stage + h * P::HALF;
      const int t0 = chunk_at(step, h) * C;
      copy_rows<C, N * sizeof(T), TH>(dst, XP * sizeof(T), reinterpret_cast<const uint8_t*>(X),
                                      N * sizeof(T), t0, seq);
      copy_rows<C, N * 4, TH>(dst + P::X_BYTES, XP * 4,
                              reinterpret_cast<const uint8_t*>(a.logw + head), N * 4, t0, seq);
      copy_rows<C, N * sizeof(TY), TH>(dst + P::X_BYTES + P::L_BYTES, XP * sizeof(TY),
                                       reinterpret_cast<const uint8_t*>(Y), N * sizeof(TY), t0,
                                       seq);
    }
    cp_async_commit();
  };
  // the state as it stands before chunk c: S_in[c] (S chain, c <= nc) or
  // after it, G_end[c] (G chain, c >= 0)
  auto store = [&](int c) {
    float* dst = G_CHAIN ? a.gst + ((size_t)bh * nc + c) * N * N
                         : a.sst + ((size_t)bh * (nc + 1) + c) * N * N;
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = j0 + g + 8 * h, m = c0 + 8 * nt + 2 * q;
        *reinterpret_cast<float2*>(dst + (size_t)j * N + m) = {st[nt][2 * h], st[nt][2 * h + 1]};
      }
    }
  };
  if (steps > 0) issue(sm, 0);
  for (int it = 0; it < steps; ++it) {
    uint8_t* stage = sm + (it & 1) * P::STAGE;
    store(chunk_at(it, 0));
    cp_async_wait_all();
    __syncthreads();  // the step has landed; the other stage is free
    if (it + 1 < steps) issue(sm + ((it + 1) & 1) * P::STAGE, it + 1);
    // each chunk's cum by its share of the threads
    const int mine = threadIdx.x / (TH / CPS);
    cum_scan<N, C, XP, TH / CPS>(reinterpret_cast<float*>(stage + mine * P::HALF + P::X_BYTES),
                                 threadIdx.x % (TH / CPS));
    __syncthreads();  // cum is in
    float ce[CPS][2], acc[CPS][NTW][4];  // a chunk's cum_end of rows j0 + g, + 8; its product
#pragma unroll
    for (int h = 0; h < CPS; ++h) {
      const float* Ls = reinterpret_cast<const float*>(stage + h * P::HALF + P::X_BYTES);
      ce[h][0] = Ls[(C - 1) * XP + j0 + g], ce[h][1] = Ls[(C - 1) * XP + j0 + g + 8];
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt) zero(acc[h][nt]);
    }
#pragma unroll
    for (int t0 = 0; t0 < C; t0 += 8) {
#pragma unroll
      for (int h = 0; h < CPS; ++h) {
        const T* Xs = reinterpret_cast<const T*>(stage + h * P::HALF);
        const float* Ls = reinterpret_cast<const float*>(stage + h * P::HALF + P::X_BYTES);
        const TY* Ys = reinterpret_cast<const TY*>(stage + h * P::HALF + P::X_BYTES + P::L_BYTES);
        // A (j, t) = X[t][j] 2^{E}: E = cum_end - cum (S) or cum_ex (G)
        float x[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = j0 + g + 8 * (e % 2), t = t0 + q + 4 * (e / 2);
          const float xv = ldT(Xs + t * XP + j);
          const float ex = G_CHAIN ? (t > 0 ? Ls[(t - 1) * XP + j] : 0.f)
                                   : ce[h][e % 2] - Ls[t * XP + j];
          x[e] = xv * ex2(ex);
        }
        const FragA fa = split_a(x[0], x[1], x[2], x[3]);
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt)
          mma3<Exact<TY>::value>(acc[h][nt], fa, ldT(Ys + (t0 + q) * XP + c0 + 8 * nt + g),
                                 ldT(Ys + (t0 + q + 4) * XP + c0 + 8 * nt + g));
      }
    }
#pragma unroll
    for (int h = 0; h < CPS; ++h) {
      if (h == 1) {  // the state between the step's chunks: S_in[2 it + 1], G_end[lo]
        const int c1 = chunk_at(it, 1);
        if (c1 >= 0) store(c1);
      }
      const float dec[2] = {ex2(ce[h][0]), ex2(ce[h][1])};
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) st[nt][e] = fmaf(dec[e / 2], st[nt][e], acc[h][nt][e]);
      }
    }
  }
  if (G_CHAIN) {
    float* d0 = a.dstate0 + (size_t)bh * N * N;
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = j0 + g + 8 * h, m = c0 + 8 * nt + 2 * q;
        *reinterpret_cast<float2*>(d0 + (size_t)j * N + m) = {st[nt][2 * h], st[nt][2 * h + 1]};
      }
    }
  } else {
    store(nc);  // S_T
  }
}

template <int N, typename T>
__global__ void __launch_bounds__(StatePlan<N, T>::THREADS) wkv6_bwd_state_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(smem4);
  if (blockIdx.x == 0)
    state_chain<N, T, false>(a, sm, blockIdx.y);
  else
    state_chain<N, T, true>(a, sm, blockIdx.y);
}

// ---------------------------------------------------------------- pass chunk
// A block: one chunk of one head, W warps (8; 4 at N 16). Warp w takes the
// key tile (16 keys) kt = w % KT and the token blocks i = w / KT + TS p
// (p < IPW): for those it computes dv^T (value tile kt), h^T and f^T (key
// tile kt) with the keys (or value columns) as the mma's rows and the
// tokens as its columns.
template <int N, typename T>
struct ChunkPlan {
  static constexpr int C = Chunk<N>::C, NB = C / BLK, KT = N / 16, W = N == 16 ? 4 : 8;
  static constexpr int TS = W / KT, IPW = NB / TS, THREADS = 32 * W, KS = N / 8;
  // row pitches (elements): T arrays N + 8, fp32 arrays N + 4, X C + 4
  static constexpr int PT = sizeof(T) == 4 ? N + 4 : N + 8, PF = N + 4, PX = C + 4;
  static constexpr int T_BYTES = C * PT * (int)sizeof(T), F_BYTES = C * PF * 4;
  static constexpr int R = 0, K = T_BYTES, V = 2 * T_BYTES, DO = 3 * T_BYTES, L = DO + F_BYTES,
                       X = L + F_BYTES, E = X + C * PX * 4, B = E + C * 4, D = B + C * 4,
                       BYTES = D + N * 4;
  static_assert(W % KT == 0 && NB % TS == 0 && W % NB == 0, "whole tiles");
  static_assert(T_BYTES % 16 == 0 && F_BYTES % 16 == 0, "16-byte arrays");
};

// The A fragments (rows r0 + g, + 8; columns 8 ks + q, + 4) of a row-major
// N x N state in global memory, every k-step's at once; or, TRANS, of its
// transpose (the state's rows 8 ks + q, + 4 and columns r0 + g, + 8)
template <int N, bool TRANS>
__device__ __forceinline__ void load_state(float (&x)[N / 8][4], const float* s, int r0, int g,
                                           int q) {
#pragma unroll
  for (int ks = 0; ks < N / 8; ++ks) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + g + 8 * (e % 2), col = 8 * ks + q + 4 * (e / 2);
      x[ks][e] = TRANS ? s[(size_t)col * N + row] : s[(size_t)row * N + col];
    }
  }
}

template <int N, typename T>
__global__ void __launch_bounds__(ChunkPlan<N, T>::THREADS) wkv6_bwd_chunk_kernel(const Args a) {
  using P = ChunkPlan<N, T>;
  constexpr int C = P::C, NB = P::NB, KT = P::KT, TS = P::TS, IPW = P::IPW, KS = P::KS,
                PT = P::PT, PF = P::PF, PX = P::PX, THREADS = P::THREADS, WARPS = P::W;
  constexpr int HB = BLK / 2;          // a block's halves: 8 tokens
  constexpr int TPW = C / WARPS;       // tokens a warp for e_t and b_t
  constexpr bool VX = Exact<T>::value;  // v is exact in TF32
  extern __shared__ float4 smem4[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(smem4);
  const T* R = reinterpret_cast<const T*>(sm + P::R);
  const T* K = reinterpret_cast<const T*>(sm + P::K);
  const T* V = reinterpret_cast<const T*>(sm + P::V);
  float* DO = reinterpret_cast<float*>(sm + P::DO);
  float* L = reinterpret_cast<float*>(sm + P::L);
  float* X = reinterpret_cast<float*>(sm + P::X);
  float* E = reinterpret_cast<float*>(sm + P::E);
  float* B = reinterpret_cast<float*>(sm + P::B);
  float* D = reinterpret_cast<float*>(sm + P::D);

  const int c = blockIdx.x, bh = blockIdx.y, seq = a.seq, nc = a.nc, t0 = c * C;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, q = lane % 4;
  const int ts = warp / KT, j0 = 16 * (warp % KT);  // keys (or value columns) j0 + g (+ 8)
  const size_t head = (size_t)bh * seq * N;
  const float* s_in = a.sst + ((size_t)bh * (nc + 1) + c) * N * N;
  const float* s_end = s_in + (size_t)N * N;
  const float* g_end = a.gst + ((size_t)bh * nc + c) * N * N;
  // ------------------------------------------------ tiles, cum, e_t, b_t, D_end
  {
    constexpr int TB = N * sizeof(T), FB = N * 4;
    copy_rows<C, TB, THREADS>(sm + P::R, PT * sizeof(T),
                              static_cast<const uint8_t*>(a.r) + head * sizeof(T), TB, t0, seq);
    copy_rows<C, TB, THREADS>(sm + P::K, PT * sizeof(T),
                              static_cast<const uint8_t*>(a.k) + head * sizeof(T), TB, t0, seq);
    copy_rows<C, TB, THREADS>(sm + P::V, PT * sizeof(T),
                              static_cast<const uint8_t*>(a.v) + head * sizeof(T), TB, t0, seq);
    copy_rows<C, FB, THREADS>(sm + P::DO, PF * 4, reinterpret_cast<const uint8_t*>(a.dout + head),
                              FB, t0, seq);
    copy_rows<C, FB, THREADS>(sm + P::L, PF * 4, reinterpret_cast<const uint8_t*>(a.logw + head),
                              FB, t0, seq);
    cp_async_commit();
  }
  for (int line = threadIdx.x; line < N * N / 32; line += THREADS)  // h reads S_in from L2
    prefetch_l2(s_in + 32 * line);
  {  // D_end = rowsum(S_end * G_end): THREADS / N threads a key, float4 loads
    constexpr int TPK = THREADS / N < N / 4 ? THREADS / N : N / 4, PER = N / TPK;
    const int j = threadIdx.x / TPK, part = threadIdx.x % TPK;
    float d = 0.f;
    if (j < N) {
#pragma unroll
      for (int m = PER * part; m < PER * (part + 1); m += 4) {
        const float4 x = *reinterpret_cast<const float4*>(s_end + (size_t)j * N + m);
        const float4 y = *reinterpret_cast<const float4*>(g_end + (size_t)j * N + m);
        d = fmaf(x.x, y.x, d), d = fmaf(x.y, y.y, d), d = fmaf(x.z, y.z, d), d = fmaf(x.w, y.w, d);
      }
    }
#pragma unroll
    for (int off = 1; off < TPK; off <<= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
    if (j < N && part == 0) D[j] = d;
  }
  cp_async_wait_all();
  __syncthreads();
  cum_scan<N, C, PF, THREADS>(L, threadIdx.x);
  {  // e_t = do_t . v_t, b_t = r_t . (u * k_t): a warp TPW tokens, lanes over keys
    float e[TPW], b[TPW];
#pragma unroll
    for (int m = 0; m < TPW; ++m) e[m] = b[m] = 0.f;
    for (int n = lane; n < N; n += 32) {
      const float uk = a.u[(size_t)bh * N + n];
#pragma unroll
      for (int m = 0; m < TPW; ++m) {
        const int t = TPW * warp + m;
        e[m] = fmaf(DO[t * PF + n], ldT(V + t * PT + n), e[m]);
        b[m] = fmaf(ldT(R + t * PT + n) * uk, ldT(K + t * PT + n), b[m]);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int m = 0; m < TPW; ++m) {
        e[m] += __shfl_xor_sync(0xffffffffu, e[m], off);
        b[m] += __shfl_xor_sync(0xffffffffu, b[m], off);
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int m = 0; m < TPW; ++m) E[TPW * warp + m] = e[m], B[TPW * warp + m] = b[m];
    }
  }
  __syncthreads();  // cum, e and b are in
  auto cum_ex = [&](int t, int j) { return t > 0 ? L[(t - 1) * PF + j] : 0.f; };

  // ------------------------------------------------ dA and A into X
  // X[t][s] = dA[t][s] (s < t), X[s][t] = A[t][s] (s < t); the diagonal unused.
  // Items: the dA blocks (i, j <= i); the A blocks (i, j < i), factorised at
  // block j's last token; in each diagonal block, A's second half against
  // its first (rows 8 to 15 of an m16 tile zero), factorised at token 7.
  {
    constexpr int NDA = NB * (NB + 1) / 2, NA = NB * (NB - 1) / 2;
    for (int item = warp; item < NDA + NA + NB; item += WARPS) {
      float acc[2][4];
      zero(acc[0]), zero(acc[1]);
      if (item < NDA) {  // dO_i V_j^T over the values
        int i = 0, j = item;
        while (j > i) j -= ++i;
        const int rt = BLK * i + g, cs = BLK * j;  // rows t, t + 8; first column s
#pragma unroll 4
        for (int m0 = 0; m0 < N; m0 += 8) {
          const FragA fa =
              split_a(DO[rt * PF + m0 + q], DO[(rt + 8) * PF + m0 + q], DO[rt * PF + m0 + q + 4],
                      DO[(rt + 8) * PF + m0 + q + 4]);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const T* vs = V + (cs + 8 * nt + g) * PT + m0 + q;
            mma3<VX>(acc[nt], fa, ldT(vs), ldT(vs + 4));
          }
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int t = rt + 8 * (e / 2), s = cs + 8 * nt + 2 * q + e % 2;
            if (s < t) X[t * PX + s] = acc[nt][e];
          }
        }
      } else {
        // (r_i 2^{cum_ex - ref}) (k_j 2^{ref - cum})^T over the keys: block
        // (i, j < i) with ref = cum at j's last token, or a diagonal block's
        // quadrant (rows b0 + 8.., columns b0..) with ref = cum at b0 + 7
        const bool quad = item >= NDA + NA;
        int i, j;
        if (quad) {
          i = j = item - NDA - NA;
        } else {
          i = 1, j = item - NDA;
          while (j >= i) j -= i++;
        }
        const int rt = BLK * i + (quad ? HB : 0) + g, cs = BLK * j, nts = quad ? 1 : 2;
        const float* ref = L + (cs + (quad ? HB : BLK) - 1) * PF;
#pragma unroll 2
        for (int n0 = 0; n0 < N; n0 += 8) {
          float x[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int t = rt + 8 * (e % 2), n = n0 + q + 4 * (e / 2);
            x[e] = quad && e % 2 ? 0.f : ldT(R + t * PT + n) * ex2(L[(t - 1) * PF + n] - ref[n]);
          }
          const FragA fa = split_a(x[0], x[1], x[2], x[3]);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            if (nt < nts) {
              const int s = cs + 8 * nt + g, n = n0 + q;
              mma3<false>(acc[nt], fa, ldT(K + s * PT + n) * ex2(ref[n] - L[s * PF + n]),
                          ldT(K + s * PT + n + 4) * ex2(ref[n + 4] - L[s * PF + n + 4]));
            }
          }
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int t = rt + 8 * (e / 2), s = cs + 8 * nt + 2 * q + e % 2;
            if (nt < nts && !(quad && e >= 2)) X[s * PX + t] = acc[nt][e];
          }
        }
      }
    }
    // A inside each 8-token half of the diagonal blocks, pairwise: a thread
    // a pair (t > s), over every key in four partial sums (the lanes start
    // at different keys, against bank conflicts)
    constexpr int HPAIRS = HB * (HB - 1) / 2, PAIRS = 2 * NB * HPAIRS;
    for (int pi = threadIdx.x; pi < PAIRS; pi += THREADS) {
      const int half = pi / HPAIRS;  // 2 d + the half
      int p = pi % HPAIRS, t = 1;
      while (p >= t) p -= t++;
      const int tt = HB * half + t, ss = HB * half + p;
      float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int n0 = 0; n0 < N; n0 += 4) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int n = (n0 + u + lane) & (N - 1);
          part[u] = fmaf(ldT(R + tt * PT + n) * ldT(K + ss * PT + n),
                         ex2(L[(tt - 1) * PF + n] - L[ss * PF + n]), part[u]);
        }
      }
      X[ss * PX + tt] = (part[0] + part[1]) + (part[2] + part[3]);
    }
  }
  __syncthreads();  // X is in

  // ------------------------------------------------ dv^T = G_end^T kd^T + dO^T A
  {
    const int m0 = j0;  // value columns m0 + g (+ 8)
    float acc[IPW][2][4];
#pragma unroll
    for (int ii = 0; ii < IPW; ++ii) zero(acc[ii][0]), zero(acc[ii][1]);
    {
      float gc[KS][4];  // A (m, j) = G_end[j][m]
      load_state<N, true>(gc, g_end, m0, g, q);
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const int j = 8 * ks + q;
        const FragA fa = split_a(gc[ks][0], gc[ks][1], gc[ks][2], gc[ks][3]);
        const float ce0 = L[(C - 1) * PF + j], ce1 = L[(C - 1) * PF + j + 4];
#pragma unroll
        for (int ii = 0; ii < IPW; ++ii) {
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const int s = BLK * (ts + TS * ii) + 8 * nt + g;  // B (j, s) = k[s][j] 2^{cum_end - cum}
            mma3<false>(acc[ii][nt], fa, ldT(K + s * PT + j) * ex2(ce0 - L[s * PF + j]),
                        ldT(K + s * PT + j + 4) * ex2(ce1 - L[s * PF + j + 4]));
          }
        }
      }
    }
#pragma unroll 1
    for (int tb = 0; tb < NB; ++tb) {  // over the later tokens: A (m, t) = dO[t][m]
#pragma unroll
      for (int h8 = 0; h8 < BLK; h8 += 8) {
        const int tt = BLK * tb + h8 + q;
        const FragA fa = split_a(DO[tt * PF + m0 + g], DO[tt * PF + m0 + g + 8],
                                 DO[(tt + 4) * PF + m0 + g], DO[(tt + 4) * PF + m0 + g + 8]);
#pragma unroll
        for (int ii = 0; ii < IPW; ++ii) {
          const int i = ts + TS * ii;
          if (i > tb) continue;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {  // B (t, s) = A[t][s] = X[s][t], t > s
            const int s = BLK * i + 8 * nt + g;
            mma3<false>(acc[ii][nt], fa, tt > s ? X[s * PX + tt] : 0.f,
                        tt + 4 > s ? X[s * PX + tt + 4] : 0.f);
          }
        }
      }
    }
#pragma unroll
    for (int ii = 0; ii < IPW; ++ii) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = m0 + g + 8 * (e / 2), s = BLK * (ts + TS * ii) + 8 * nt + 2 * q + e % 2;
          if (t0 + s < seq)
            stT(static_cast<T*>(a.dv) + head + (size_t)(t0 + s) * N + m,
                fmaf(B[s], DO[s * PF + m], acc[ii][nt][e]));
        }
      }
    }
  }
  // ------------------------------------------------ h^T and f^T
  // the warp's keys and tokens; h and f stay in registers to the end
  float hh[IPW][2][4], ff[IPW][2][4];
  {  // h: 2^{cum_ex} (S_in dO^T) + intra + the diagonal block
    float sa[KS][4];  // A (j, m) = S_in[j][m]
    load_state<N, false>(sa, s_in, j0, g, q);
#pragma unroll
    for (int ii = 0; ii < IPW; ++ii) zero(hh[ii][0]), zero(hh[ii][1]);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const FragA fa = split_a(sa[ks][0], sa[ks][1], sa[ks][2], sa[ks][3]);
#pragma unroll
      for (int ii = 0; ii < IPW; ++ii) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {  // B (m, t) = dO[t][m]
          const float* dor = DO + (BLK * (ts + TS * ii) + 8 * nt + g) * PF + 8 * ks + q;
          mma3<false>(hh[ii][nt], fa, dor[0], dor[4]);
        }
      }
    }
  }
#pragma unroll
  for (int ii = 0; ii < IPW; ++ii) {
    const int i = ts + TS * ii, b0 = BLK * i;
    float acc[2][4], acc8[4];
    zero(acc[0]), zero(acc[1]), zero(acc8);
    const float ref[2] = {i > 0 ? L[(b0 - 1) * PF + j0 + g] : 0.f,
                          i > 0 ? L[(b0 - 1) * PF + j0 + g + 8] : 0.f};
    const float ref8[2] = {L[(b0 + HB - 1) * PF + j0 + g], L[(b0 + HB - 1) * PF + j0 + g + 8]};
#pragma unroll 1
    for (int s0 = 0; s0 < b0; s0 += 8) {  // A (j, s) = k[s][j] 2^{ref - cum}
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + g + 8 * (e % 2), s = s0 + q + 4 * (e / 2);
        x[e] = ldT(K + s * PT + j) * ex2(ref[e % 2] - L[s * PF + j]);
      }
      const FragA fa = split_a(x[0], x[1], x[2], x[3]);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {  // B (s, t) = dA[t][s] = X[t][s]
        const float* xr = X + (b0 + 8 * nt + g) * PX + s0 + q;
        mma3<false>(acc[nt], fa, xr[0], xr[4]);
      }
    }
    {  // the block's second half against its first, factorised at token b0 + 7
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + g + 8 * (e % 2), s = b0 + q + 4 * (e / 2);
        x[e] = ldT(K + s * PT + j) * ex2(ref8[e % 2] - L[s * PF + j]);
      }
      const float* xr = X + (b0 + HB + g) * PX + b0 + q;
      mma3<false>(acc8, split_a(x[0], x[1], x[2], x[3]), xr[0], xr[4]);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e / 2, j = j0 + g + 8 * row, tl = 2 * q + e % 2, t = b0 + HB * nt + tl;
        const float cx = cum_ex(t, j);
        float pair = 0.f;  // s in the same half, s < t
#pragma unroll
        for (int so = 0; so < HB - 1; ++so) {
          if (so < tl) {
            const int s = b0 + HB * nt + so;
            pair = fmaf(X[t * PX + s] * ldT(K + s * PT + j), ex2(cx - L[s * PF + j]), pair);
          }
        }
        float x = fmaf(ex2(cx), hh[ii][nt][e], i > 0 ? ex2(cx - ref[row]) * acc[nt][e] : 0.f);
        if (nt == 1) x = fmaf(ex2(cx - ref8[row]), acc8[e], x);
        hh[ii][nt][e] = x + pair;
      }
    }
  }
  {  // f: 2^{cum_end - cum} (G_end V^T) + intra + the diagonal block
    float ga[KS][4];  // A (j, m) = G_end[j][m]
    load_state<N, false>(ga, g_end, j0, g, q);
#pragma unroll
    for (int ii = 0; ii < IPW; ++ii) zero(ff[ii][0]), zero(ff[ii][1]);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const FragA fa = split_a(ga[ks][0], ga[ks][1], ga[ks][2], ga[ks][3]);
#pragma unroll
      for (int ii = 0; ii < IPW; ++ii) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {  // B (m, t) = v[t][m]
          const T* vr = V + (BLK * (ts + TS * ii) + 8 * nt + g) * PT + 8 * ks + q;
          mma3<VX>(ff[ii][nt], fa, ldT(vr), ldT(vr + 4));
        }
      }
    }
  }
#pragma unroll
  for (int ii = 0; ii < IPW; ++ii) {
    const int i = ts + TS * ii, b0 = BLK * i, last = b0 + BLK - 1;
    float acc[2][4], acc8[4];
    zero(acc[0]), zero(acc[1]), zero(acc8);
    const float ref[2] = {L[last * PF + j0 + g], L[last * PF + j0 + g + 8]};
    const float ref8[2] = {L[(b0 + HB - 1) * PF + j0 + g], L[(b0 + HB - 1) * PF + j0 + g + 8]};
#pragma unroll 1
    for (int u0 = b0 + BLK; u0 < C; u0 += 8) {  // A (j, t') = r[t'][j] 2^{cum_ex - ref}
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + g + 8 * (e % 2), t = u0 + q + 4 * (e / 2);
        x[e] = ldT(R + t * PT + j) * ex2(L[(t - 1) * PF + j] - ref[e % 2]);
      }
      const FragA fa = split_a(x[0], x[1], x[2], x[3]);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {  // B (t', t) = dA[t'][t] = X[t'][t]
        const float* xc = X + (u0 + q) * PX + b0 + 8 * nt + g;
        mma3<false>(acc[nt], fa, xc[0], xc[4 * PX]);
      }
    }
    {  // the block's first half against its second, factorised at token b0 + 7
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + g + 8 * (e % 2), t = b0 + HB + q + 4 * (e / 2);
        x[e] = ldT(R + t * PT + j) * ex2(L[(t - 1) * PF + j] - ref8[e % 2]);
      }
      const float* xc = X + (b0 + HB + q) * PX + b0 + g;
      mma3<false>(acc8, split_a(x[0], x[1], x[2], x[3]), xc[0], xc[4 * PX]);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e / 2, j = j0 + g + 8 * row, tl = 2 * q + e % 2, t = b0 + HB * nt + tl;
        const float cu = L[t * PF + j];
        float pair = 0.f;  // t' in the same half, t' > t
#pragma unroll
        for (int uo = 1; uo < HB; ++uo) {
          if (tl + uo < HB) {
            const int u = t + uo;
            pair = fmaf(X[u * PX + t] * ldT(R + u * PT + j), ex2(L[(u - 1) * PF + j] - cu), pair);
          }
        }
        float x = fmaf(ex2(L[(C - 1) * PF + j] - cu), ff[ii][nt][e],
                       i < NB - 1 ? ex2(ref[row] - cu) * acc[nt][e] : 0.f);
        if (nt == 0) x = fmaf(ex2(ref8[row] - cu), acc8[e], x);
        ff[ii][nt][e] = x + pair;
      }
    }
  }

  __syncthreads();  // dO and X are read for the last time: their rooms take dlogw's sums

  // ------------------------------------------------ dlogw, dr, dk, du
  // x_t = r_t h_t - k_t f_t into the dO room; then a thread a key and
  // segment replaces it by sum_{s > t} x_s (its segment's, then the later
  // segments' totals through the X room); dlogw_t = D_end - k_t f_t + that
  float* SX = DO;
#pragma unroll
  for (int ii = 0; ii < IPW; ++ii) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + g + 8 * (e / 2), t = BLK * (ts + TS * ii) + 8 * nt + 2 * q + e % 2;
        SX[t * PF + j] =
            fmaf(ldT(R + t * PT + j), hh[ii][nt][e], -ldT(K + t * PT + j) * ff[ii][nt][e]);
      }
    }
  }
  __syncthreads();
  {
    constexpr int SEGS = THREADS / N < C / 8 ? THREADS / N : C / 8, SL = C / SEGS;
    const int j = threadIdx.x % N, sg = threadIdx.x / N;
    float* total = X;  // [SEGS][N]
    if (sg < SEGS) {
      float acc = 0.f;
#pragma unroll
      for (int t = SL * (sg + 1) - 1; t >= SL * sg; --t) {
        const float x = SX[t * PF + j];
        SX[t * PF + j] = acc;
        acc += x;
      }
      total[sg * N + j] = acc;
    }
    __syncthreads();
    if (sg < SEGS - 1) {
      float off = 0.f;
      for (int u = SEGS - 1; u > sg; --u) off += total[u * N + j];
#pragma unroll
      for (int t = SL * sg; t < SL * (sg + 1); ++t) SX[t * PF + j] += off;
    }
  }
  __syncthreads();
  {
    const float uu[2] = {a.u[(size_t)bh * N + j0 + g], a.u[(size_t)bh * N + j0 + g + 8]};
    float du[2] = {0.f, 0.f};
#pragma unroll
    for (int ii = 0; ii < IPW; ++ii) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = e / 2, j = j0 + g + 8 * row,
                    t = BLK * (ts + TS * ii) + 8 * nt + 2 * q + e % 2;
          const float rj = ldT(R + t * PT + j), kj = ldT(K + t * PT + j), et = E[t];
          du[row] = fmaf(rj * kj, et, du[row]);
          if (t0 + t < seq) {
            const size_t o = head + (size_t)(t0 + t) * N + j;
            const float y = -kj * ff[ii][nt][e];
            a.dlogw[o] = D[j] + y + SX[t * PF + j];
            stT(static_cast<T*>(a.dr) + o, fmaf(uu[row] * kj, et, hh[ii][nt][e]));
            stT(static_cast<T*>(a.dk) + o, fmaf(uu[row] * rj, et, ff[ii][nt][e]));
          }
        }
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      du[0] += __shfl_xor_sync(0xffffffffu, du[0], off);
      du[1] += __shfl_xor_sync(0xffffffffu, du[1], off);
    }
    if (q == 0) {
      float* dp = a.dupart + (((size_t)bh * nc + c) * TS + ts) * N + j0 + g;
      dp[0] = du[0], dp[8] = du[1];
    }
  }
}

// ---------------------------------------------------------------- pass sum
template <int N, typename T>
__global__ void __launch_bounds__(SUM_THREADS) wkv6_bwd_sum_kernel(const Args a) {
  constexpr int TS = ChunkPlan<N, T>::TS;
  const size_t i = (size_t)blockIdx.x * SUM_THREADS + threadIdx.x;
  if (i >= (size_t)a.bh * N) return;
  const size_t bh = i / N, j = i % N;
  float du = 0.f;
  for (int x = 0; x < a.nc * TS; ++x) du += a.dupart[(bh * a.nc * TS + x) * N + j];
  a.du[i] = du;
}

// ---------------------------------------------------------------- host side
template <int N>
constexpr int token_splits() { return ChunkPlan<N, float>::TS; }

int chunk_of(int n) {
  switch (n) {
    case 16: return Chunk<16>::C;
    case 32: return Chunk<32>::C;
    case 64: return Chunk<64>::C;
    case 128: return Chunk<128>::C;
    default: return 0;
  }
}

int splits_of(int n) {
  switch (n) {
    case 16: return token_splits<16>();
    case 32: return token_splits<32>();
    case 64: return token_splits<64>();
    case 128: return token_splits<128>();
    default: return 0;
  }
}

int chunks(int seq, int n) { return seq > 0 ? (seq + chunk_of(n) - 1) / chunk_of(n) : 0; }

// The scratch a call needs, in floats: the states [BH][nc + 1][N][N] and
// [BH][nc][N][N], the shares of du [BH][nc][TS][N].
long long scratch_floats(int bh, int seq, int n) {
  const long long nc = chunks(seq, n);
  return (long long)bh * (2 * nc + 1) * n * n + (long long)bh * nc * splits_of(n) * n;
}

Args make_args(const void* r, const void* k, const void* v, const void* logw, const void* u,
               const void* state0, const void* dout, const void* dstate, void* dr, void* dk,
               void* dv, void* dlogw, void* du, void* dstate0, void* scratch, int bh, int seq,
               int n) {
  Args a;
  a.r = r, a.k = k, a.v = v;
  a.logw = static_cast<const float*>(logw), a.u = static_cast<const float*>(u);
  a.state0 = static_cast<const float*>(state0), a.dout = static_cast<const float*>(dout);
  a.dstate = static_cast<const float*>(dstate);
  a.dr = dr, a.dk = dk, a.dv = dv;
  a.dlogw = static_cast<float*>(dlogw), a.du = static_cast<float*>(du);
  a.dstate0 = static_cast<float*>(dstate0);
  a.nc = chunks(seq, n);
  a.sst = static_cast<float*>(scratch);
  a.gst = a.sst + (size_t)bh * (a.nc + 1) * n * n;
  a.dupart = a.gst + (size_t)bh * a.nc * n * n;
  a.bh = bh, a.seq = seq;
  return a;
}

enum Pass { kState = 0, kChunk = 1, kSum = 2 };

template <int N, typename T>
int pass_bytes(int pass) {
  return pass == kState ? StatePlan<N, T>::BYTES : pass == kChunk ? ChunkPlan<N, T>::BYTES : 0;
}

template <int N, typename T>
cudaError_t launch(int pass, const Args& a, cudaStream_t stream) {
  if (pass == kSum) {
    const unsigned blocks = (unsigned)((a.bh * N + SUM_THREADS - 1) / SUM_THREADS);
    auto kernel = wkv6_bwd_sum_kernel<N, T>;
    kernel<<<blocks, SUM_THREADS, 0, stream>>>(a);
    return cudaGetLastError();
  }
  // above 48 KB a block's shared memory must be opted into
  if (pass == kState) {
    using P = StatePlan<N, T>;
    auto kernel = wkv6_bwd_state_kernel<N, T>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::BYTES);
    if (err != cudaSuccess) return err;
    kernel<<<dim3(2, a.bh), P::THREADS, P::BYTES, stream>>>(a);  // the S chain, then the G chain
  } else {
    using P = ChunkPlan<N, T>;
    if (a.nc == 0) return cudaSuccess;
    auto kernel = wkv6_bwd_chunk_kernel<N, T>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::BYTES);
    if (err != cudaSuccess) return err;
    kernel<<<dim3(a.nc, a.bh), P::THREADS, P::BYTES, stream>>>(a);
  }
  return cudaGetLastError();
}

template <typename T>
int run(int pass, const void* r, const void* k, const void* v, const void* logw, const void* u,
        const void* state0, const void* dout, const void* dstate, void* dr, void* dk, void* dv,
        void* dlogw, void* du, void* dstate0, void* scratch, int bh, int seq, int n,
        void* stream) {
  if (bh < 1 || bh > 65535 || seq < 0 || chunk_of(n) == 0) return cudaErrorInvalidValue;
  const Args a = make_args(r, k, v, logw, u, state0, dout, dstate, dr, dk, dv, dlogw, du,
                           dstate0, scratch, bh, seq, n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 16: return launch<16, T>(pass, a, s);
    case 32: return launch<32, T>(pass, a, s);
    case 64: return launch<64, T>(pass, a, s);
    case 128: return launch<128, T>(pass, a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The three passes, each for r, k, v (and dr, dk, dv) in the dtype its name
// says, one signature: r, k, v, logw, u, state0 (or null), dout, dstate (or
// null), dr, dk, dv, dlogw, du, dstate0, scratch (wkv6_bwd_scratch_bytes),
// bh, seq, n, stream. Launched in order on one stream: state, then chunk,
// then sum. Each returns the cudaError_t of its launch (cudaErrorInvalidValue
// for a head size it does not take).
#define WKV6_BWD_ENTRY(NAME, PASS, TYPE)                                                        \
  extern "C" int NAME(const void* r, const void* k, const void* v, const void* logw,           \
                      const void* u, const void* state0, const void* dout, const void* dstate, \
                      void* dr, void* dk, void* dv, void* dlogw, void* du, void* dstate0,      \
                      void* scratch, int bh, int seq, int n, void* stream) {                   \
    return run<TYPE>(PASS, r, k, v, logw, u, state0, dout, dstate, dr, dk, dv, dlogw, du,      \
                     dstate0, scratch, bh, seq, n, stream);                                    \
  }
WKV6_BWD_ENTRY(wkv6_bwd_state_f32, kState, float)
WKV6_BWD_ENTRY(wkv6_bwd_chunk_f32, kChunk, float)
WKV6_BWD_ENTRY(wkv6_bwd_sum_f32, kSum, float)
WKV6_BWD_ENTRY(wkv6_bwd_state_bf16, kState, __nv_bfloat16)
WKV6_BWD_ENTRY(wkv6_bwd_chunk_bf16, kChunk, __nv_bfloat16)
WKV6_BWD_ENTRY(wkv6_bwd_sum_bf16, kSum, __nv_bfloat16)
#undef WKV6_BWD_ENTRY

// The scratch bytes a call of head size n needs (-1 for a head size the
// kernel does not take).
extern "C" long long wkv6_bwd_scratch_bytes(int bh, int seq, int n) {
  return chunk_of(n) ? 4 * scratch_floats(bh, seq, n) : -1;
}

// The dynamic shared memory a block of pass `pass` (0 state, 1 chunk)
// launches with, for head size n and dtype (0 fp32, 1 bf16); 0 for what it
// does not take.
extern "C" int wkv6_bwd_smem_bytes(int n, int dtype, int pass) {
  if (dtype != 0 && dtype != 1) return 0;
  switch (n) {
    case 16: return dtype ? pass_bytes<16, __nv_bfloat16>(pass) : pass_bytes<16, float>(pass);
    case 32: return dtype ? pass_bytes<32, __nv_bfloat16>(pass) : pass_bytes<32, float>(pass);
    case 64: return dtype ? pass_bytes<64, __nv_bfloat16>(pass) : pass_bytes<64, float>(pass);
    case 128: return dtype ? pass_bytes<128, __nv_bfloat16>(pass) : pass_bytes<128, float>(pass);
    default: return 0;
  }
}
