// WKV6 recurrence (RWKV6 "Finch") on Hopper's tensor cores (sm_90a), for
// bf16 r, k, v, from a given state to the final one. fp32 r, k, v go to the
// CUDA-core kernel of wkv6.cu (kernels/rwkv6/kernel.py, KERNELS).
//
// Replaces the TPU kernel `wkv6_bhsn` (body `_wkv_kernel`) of
// src/repro/kernels/rwkv6/kernel.py. Per head, with an N x N state S that
// maps keys to values:
//   o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
//   S_t = diag(e^{logw_t}) S_{t-1} + k_t^T v_t
//   * r, k, v (BH, S, N) bf16; logw (BH, S, N) fp32 and <= 0; u (BH, N)
//     fp32; all contiguous and 16-byte aligned;
//   * state (BH, N, N) fp32, read as the initial state and overwritten with
//     the final one; out (BH, S, N) fp32;
//   * N is 16, 32, 64 or 128; S is any length.
//
// The least time for the work on this card is the bytes'. At the prefill
// shapes (BH 160, S 2048, N 64) the call moves ~0.3 GB and the chunked
// matrix form needs ~8e9 FLOP, 8 us on the tensor cores against ~88 us for
// the bytes. So the design spends nothing on the tensor cores' full rate
// (no wgmma, no TMA): warp-level mma.sync.m16n8k16 (bf16 in, fp32
// accumulate) for the products, and the next chunk's r, k, v, logw copied
// by cp.async into the stage as soon as this chunk's last reader of each is
// done. (A second stage costs an SM one of its blocks in flight and was
// slower on the H100; PERF.md has the times.) Measured, the kernel is bound
// by the instructions it issues, not by the bytes: the diagonal blocks on
// the CUDA cores take the largest share of a chunk (tools/wkv6_sections.py
// times each stretch between barriers; PERF.md has the split).
//
// The chunked form, exact for any decay (no clamp; the Pallas kernel
// clamps the within-chunk decay at -30, which is wrong at rwkv6's own
// decay rates). A chunk of C tokens is cut into 16-token blocks. In base 2,
// cum[t] = sum_{tau<=t} logw[tau] log2(e) per channel, cum_ex[t] =
// cum[t-1] (0 at t = 0); both fall as t grows. With e_j the last token of
// block j:
//   * scores of t in block i and s in block j < i, on the tensor cores:
//       A[t,s] = sum_n (r[t,n] 2^{cum_ex[t,n] - cum[e_j,n]})
//                    * (k[s,n] 2^{cum[e_j,n] - cum[s,n]})
//     both exponents <= 0 for any decay, so both bf16 operands are finite;
//     K~ (the second factor) is one C x N tile for every row block;
//   * the diagonal 16 x 16 blocks (s < t in one block) on the CUDA cores,
//     pairwise: no reference point lies between every such pair. A
//     running product g = k[s] w[s+1] ... w[t-1] (w = 2^{logw log2 e},
//     one exp a token and channel) gives the decay without an exp a pair;
//     the bonus r u k goes on the diagonal;
//   * o = A V + (r 2^{cum_ex}) S_bf16, the state's bf16 copy;
//   * S <- 2^{cum[C-1]} S + (k 2^{cum[C-1] - cum})^T V, in fp32 in the
//     mma accumulators.
// Every exponent is <= 0: what underflows to 0 is ~0 in truth. Rounding
// the decayed r and k, the scores and the state's copy to bf16 costs about
// 2^-9 relative a term, inside the 3e-2 bf16 tolerance.
//
// Layout: one block per (head, 64 value columns) (all N columns up to N 64:
// the work on keys, which is most of it, is then done once a head), 4
// warps. C is 64 (32 at N 128, for shared memory). Warp w owns token rows
// [16 (w % RB), +16) of a chunk (RB = C / 16 row blocks) and, where RB is
// 2, half of the block's value columns; it computes its scores, its
// diagonal block and its output tile. For the state, warp w owns the key
// rows of the 16-row m-tiles w, w + 4, ... (all value columns). Shared
// memory at N 64: a stage of 44,032 B and 39,680 B of derived tiles, so
// two blocks fit on an SM. Padded tokens of a ragged last chunk are
// zero-filled by cp.async (k = v = r = 0, logw = 0: decay 1), so they leave
// the state as it is, and their rows are never stored.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (kernels/rwkv6/_build.py), one library with wkv6.cu;
// entry point wkv6_fwd_bf16, bound with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---- PTX helpers
// 16 bytes from global to shared memory, asynchronously; the bytes past
// src_bytes (0 or 16) are filled with zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most PENDING committed groups are still in flight
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(PENDING) : "memory");
}

// Four 8 x 8 bf16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8 (16 contiguous bytes). Lane l receives in x[i] the elements
// (row l / 4, columns 2 (l % 4), +1) of matrix i, or with .trans the
// elements (rows 2 (l % 4), +1; column l / 4).
__device__ __forceinline__ void ldsm_x4(const void* row, uint32_t (&x)[4]) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(x[0]), "=r"(x[1]), "=r"(x[2]), "=r"(x[3]) : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(const void* row, uint32_t (&x)[4]) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(x[0]), "=r"(x[1]), "=r"(x[2]), "=r"(x[3]) : "r"(a));
}

// d += a b, a 16 x 16 (row), b 16 x 8 (col), bf16 in, fp32 accumulate. With
// g = lane / 4, q = lane % 4: a holds rows g, g + 8 at columns 2q, 2q + 1
// (a[0], a[1]) and 2q + 8, 2q + 9 (a[2], a[3]), row g first; b holds rows
// 2q, 2q + 1 (b0) and 2q + 8, 2q + 9 (b1) of column g; d holds rows g
// (d[0], d[1]) and g + 8 (d[2], d[3]) at columns 2q, 2q + 1.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit (x <= 0 here; underflow gives 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats as bf16 (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// ---- end PTX helpers

__device__ __forceinline__ float bf_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

constexpr int THREADS = 128, WARPS = 4;
constexpr float LOG2E = 1.4426950408889634f;

// Shapes and the shared-memory plan of one head size. bf16 rows are padded
// by 8 elements (16 bytes), so ldmatrix's eight row reads of a matrix fall
// in distinct banks; cum's fp32 rows by 4.
template <int N>
struct Plan {
  static constexpr int MT = N < 64 ? N : 64;  // value columns of a block
  static constexpr int C = N == 128 ? 32 : 64;  // tokens a chunk
  static constexpr int RB = C / 16;             // row blocks of a chunk
  static constexpr int CG = WARPS / RB;         // warps sharing a row block
  static constexpr int MTW = MT / CG;           // output columns of a warp
  static constexpr int NTW = MTW / 8;           // their n-tiles
  static constexpr int KS = N / 16;             // k-steps over the channels
  static constexpr int SMT = N / 16;            // m-tiles of the state's keys
  static constexpr int SPW = (SMT + WARPS - 1) / WARPS;  // ... a warp
  static constexpr int SNT = MT / 8;            // n-tiles of the state's columns
  static constexpr int SEGS = THREADS / N;      // scan segments a channel
  static constexpr int RS = N + 8;              // row stride of r, k, K~, S_bf16
  static constexpr int VS = MT + 8;             // row stride of v
  static constexpr int CS = N + 4;              // row stride of cum
  // the stage: r, k (C x RS bf16), v (C x VS bf16), logw (C x N fp32)
  static constexpr int R_OFF = 0;
  static constexpr int K_OFF = R_OFF + C * RS * 2;
  static constexpr int V_OFF = K_OFF + C * RS * 2;
  static constexpr int W_OFF = V_OFF + C * VS * 2;
  static constexpr int STAGE = W_OFF + C * N * 4;
  // derived tiles: cum (fp32), K~ then K^ (bf16), the state's bf16 copy
  // (S^T: MT x RS), each warp's diagonal block (16 x 24 bf16), u, the scan's
  // segment sums
  static constexpr int CUM_OFF = STAGE;
  static constexpr int KT_OFF = CUM_OFF + C * CS * 4;
  static constexpr int SB_OFF = KT_OFF + C * RS * 2;
  static constexpr int D_OFF = SB_OFF + MT * RS * 2;
  static constexpr int U_OFF = D_OFF + WARPS * 16 * 24 * 2;
  static constexpr int TOT_OFF = U_OFF + N * 4;
  static constexpr int BYTES = TOT_OFF + SEGS * N * 4;
  static_assert(RB * CG == WARPS && MTW % 16 == 0 && C % SEGS == 0, "warp split");
  static_assert(STAGE % 16 == 0 && CUM_OFF % 16 == 0 && KT_OFF % 16 == 0 &&
                SB_OFF % 16 == 0 && D_OFF % 16 == 0, "16-byte aligned tiles");
};

// The A fragment of k-step kk (channels 16 kk ..) for the 16 token rows
// from t0 of (r 2^{cum_ex - ref}): ref is cum's row `ref_row`, or 0 when
// ref_row < 0.
template <int N>
__device__ __forceinline__ void decayed_r(uint32_t (&a)[4], const __nv_bfloat16* rs,
                                          const float* cum, int t0, int kk, int ref_row,
                                          int lane) {
  using P = Plan<N>;
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {  // columns 2q, 2q + 1, then + 8
    const int n = 16 * kk + 2 * q + 8 * half;
    float2 ref = make_float2(0.f, 0.f);
    if (ref_row >= 0) ref = *reinterpret_cast<const float2*>(cum + ref_row * P::CS + n);
#pragma unroll
    for (int up = 0; up < 2; ++up) {  // rows g, then g + 8
      const int t = t0 + g + 8 * up;
      const uint32_t rr = *reinterpret_cast<const uint32_t*>(rs + t * P::RS + n);
      float2 ce = make_float2(0.f, 0.f);
      if (t > 0) ce = *reinterpret_cast<const float2*>(cum + (t - 1) * P::CS + n);
      a[2 * half + up] = pack_bf16(bf_lo(rr) * ex2(ce.x - ref.x), bf_hi(rr) * ex2(ce.y - ref.y));
    }
  }
}

// (k 2^{cum[ref(s)] - cum[s]}) as bf16 into kt, where ref(s) is the last
// token of s's 16-token block (K~) or of the chunk (K^).
template <int N, bool TO_CHUNK_END>
__device__ __forceinline__ void decayed_k(__nv_bfloat16* kt, const __nv_bfloat16* ks,
                                          const float* cum) {
  using P = Plan<N>;
  for (int i = threadIdx.x; i < P::C * N / 2; i += THREADS) {
    const int s = i / (N / 2), n = 2 * (i % (N / 2));
    const int e = TO_CHUNK_END ? P::C - 1 : (s | 15);
    const uint32_t kk = *reinterpret_cast<const uint32_t*>(ks + s * P::RS + n);
    const float2 ce = *reinterpret_cast<const float2*>(cum + e * P::CS + n);
    const float2 cs = *reinterpret_cast<const float2*>(cum + s * P::CS + n);
    *reinterpret_cast<uint32_t*>(kt + s * P::RS + n) =
        pack_bf16(bf_lo(kk) * ex2(ce.x - cs.x), bf_hi(kk) * ex2(ce.y - cs.y));
  }
}

template <int N>
__global__ void __launch_bounds__(THREADS, 2)
    wkv6_mma_kernel(const __nv_bfloat16* __restrict__ r, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const float* __restrict__ logw,
                    const float* __restrict__ u, float* __restrict__ out,
                    float* __restrict__ state, int seq) {
  using P = Plan<N>;
  constexpr int C = P::C, MT = P::MT, RS = P::RS, VS = P::VS, CS = P::CS;
  extern __shared__ __align__(16) unsigned char smem[];
  float* cum = reinterpret_cast<float*>(smem + P::CUM_OFF);
  __nv_bfloat16* kt = reinterpret_cast<__nv_bfloat16*>(smem + P::KT_OFF);
  __nv_bfloat16* sb = reinterpret_cast<__nv_bfloat16*>(smem + P::SB_OFF);
  float* us = reinterpret_cast<float*>(smem + P::U_OFF);
  float* tot = reinterpret_cast<float*>(smem + P::TOT_OFF);

  const int bh = blockIdx.y, c0 = blockIdx.x * MT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3, mi = lane >> 3, mr = lane & 7;
  const int rb = warp % P::RB, cw = (warp / P::RB) * P::MTW;  // row block, first column
  __nv_bfloat16* dg = reinterpret_cast<__nv_bfloat16*>(smem + P::D_OFF) + warp * 16 * 24;
  const size_t base = (size_t)bh * seq * N;
  float* st = state + (size_t)bh * N * N;

  // the state's key rows of this warp's m-tiles, all MT columns, in fp32
  float sacc[P::SPW][P::SNT][4];
#pragma unroll
  for (int m = 0; m < P::SPW; ++m) {
    const int mt = warp + WARPS * m;
#pragma unroll
    for (int nt = 0; nt < P::SNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = 16 * mt + g + 8 * (e >> 1), col = 8 * nt + 2 * q + (e & 1);
        sacc[m][nt][e] = mt < P::SMT ? st[(size_t)key * N + c0 + col] : 0.f;
        if (mt < P::SMT) sb[col * RS + key] = __float2bfloat16_rn(sacc[m][nt][e]);
      }
    }
  }
  for (int i = tid; i < N; i += THREADS) us[i] = u[(size_t)bh * N + i];

  // r, k, v or logw of a chunk into the stage by 16-byte cp.async copies
  // (8 bf16 or 4 fp32 each); rows past the sequence are zero-filled
  enum { R = 1, K = 2, V = 4, W = 8 };
  auto issue = [&](int chunk, int parts) {
    const int t0 = chunk * C, nt = min(C, seq - t0);
    if (parts & (R | K)) {
      for (int i = tid; i < C * N / 8; i += THREADS) {
        const int row = i / (N / 8), cv = 8 * (i % (N / 8));
        const bool live = row < nt;
        const size_t src = live ? base + (size_t)(t0 + row) * N + cv : 0;
        if (parts & R) cp_async16(smem + P::R_OFF + (row * RS + cv) * 2, r + src, live ? 16 : 0);
        if (parts & K) cp_async16(smem + P::K_OFF + (row * RS + cv) * 2, k + src, live ? 16 : 0);
      }
    }
    if (parts & V) {  // the block's columns
      for (int i = tid; i < C * MT / 8; i += THREADS) {
        const int row = i / (MT / 8), cv = 8 * (i % (MT / 8));
        const bool live = row < nt;
        const size_t src = live ? base + (size_t)(t0 + row) * N + c0 + cv : 0;
        cp_async16(smem + P::V_OFF + (row * VS + cv) * 2, v + src, live ? 16 : 0);
      }
    }
    if (parts & W) {
      for (int i = tid; i < C * N / 4; i += THREADS) {
        const int row = i / (N / 4), cv = 4 * (i % (N / 4));
        const bool live = row < nt;
        const size_t src = live ? base + (size_t)(t0 + row) * N + cv : 0;
        cp_async16(smem + P::W_OFF + (row * N + cv) * 4, logw + src, live ? 16 : 0);
      }
    }
  };

  const int chunks = (seq + C - 1) / C;
  if (chunks > 0) issue(0, R | K | V | W);
  for (int c = 0; c < chunks; ++c) {
    const bool more = c + 1 < chunks;
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();  // this chunk's stage and the state's bf16 copy are in
    const __nv_bfloat16* rs = reinterpret_cast<const __nv_bfloat16*>(smem + P::R_OFF);
    const __nv_bfloat16* ks = reinterpret_cast<const __nv_bfloat16*>(smem + P::K_OFF);
    const __nv_bfloat16* vs = reinterpret_cast<const __nv_bfloat16*>(smem + P::V_OFF);
    float* ws = reinterpret_cast<float*>(smem + P::W_OFF);  // logw, then w = e^{logw}
    const int t0 = c * C, nt = min(C, seq - t0);

    // cum per channel, SEGS segments of a channel scanned side by side
    {
      constexpr int LEN = C / P::SEGS;
      const int n = tid % N, sg = tid / N;
      float acc = 0.f;
#pragma unroll 8
      for (int t = sg * LEN; t < (sg + 1) * LEN; ++t) {
        const float l2 = ws[t * N + n] * LOG2E;
        acc += l2;
        cum[t * CS + n] = acc;
        ws[t * N + n] = ex2(l2);
      }
      tot[sg * N + n] = acc;
      __syncthreads();
      float off = 0.f;
      for (int p = 0; p < sg; ++p) off += tot[p * N + n];
      if (sg > 0) {
#pragma unroll 8
        for (int t = sg * LEN; t < (sg + 1) * LEN; ++t) cum[t * CS + n] += off;
      }
    }
    __syncthreads();
    decayed_k<N, false>(kt, ks, cum);  // K~
    __syncthreads();

    // the diagonal block of row block rb: lane (s, h) holds key token s and
    // half h of the channels
    {
      constexpr int HN = N / 2;
      const int s = lane & 15, h = lane >> 4, tb = 16 * rb;
      float gk[HN];
      float d = 0.f;
#pragma unroll
      for (int c8 = 0; c8 < HN / 8; ++c8) {
        const uint4 kk = *reinterpret_cast<const uint4*>(ks + (tb + s) * RS + h * HN + 8 * c8);
        const uint4 rr = *reinterpret_cast<const uint4*>(rs + (tb + s) * RS + h * HN + 8 * c8);
        const uint32_t kw[4] = {kk.x, kk.y, kk.z, kk.w}, rw[4] = {rr.x, rr.y, rr.z, rr.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = h * HN + 8 * c8 + 2 * e;
          gk[8 * c8 + 2 * e] = bf_lo(kw[e]);
          gk[8 * c8 + 2 * e + 1] = bf_hi(kw[e]);
          d = fmaf(bf_lo(rw[e]) * us[n], bf_lo(kw[e]), d);
          d = fmaf(bf_hi(rw[e]) * us[n + 1], bf_hi(kw[e]), d);
        }
      }
      d += __shfl_xor_sync(0xffffffffu, d, 16);
      for (int t = 0; t < 16; ++t) {
        float a = 0.f, ap[4] = {0.f, 0.f, 0.f, 0.f};  // 4 chains, not one
        if (t > s) {
#pragma unroll
          for (int c8 = 0; c8 < HN / 8; ++c8) {
            const uint4 rr =
                *reinterpret_cast<const uint4*>(rs + (tb + t) * RS + h * HN + 8 * c8);
            const float4 w0 = *reinterpret_cast<const float4*>(ws + (tb + t) * N + h * HN + 8 * c8);
            const float4 w1 =
                *reinterpret_cast<const float4*>(ws + (tb + t) * N + h * HN + 8 * c8 + 4);
            const uint32_t rw[4] = {rr.x, rr.y, rr.z, rr.w};
            const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              ap[e] = fmaf(bf_lo(rw[e]), gk[8 * c8 + 2 * e], ap[e]);
              ap[e] = fmaf(bf_hi(rw[e]), gk[8 * c8 + 2 * e + 1], ap[e]);
            }
#pragma unroll
            for (int e = 0; e < 8; ++e) gk[8 * c8 + e] *= wv[e];
          }
          a = (ap[0] + ap[1]) + (ap[2] + ap[3]);
        }
        a += __shfl_xor_sync(0xffffffffu, a, 16);
        if (h == 0) dg[t * 24 + s] = __float2bfloat16_rn(t > s ? a : (t == s ? d : 0.f));
      }
      __syncwarp();
    }

    // this warp's output tile: 16 tokens x MTW columns
    {
      float o[P::NTW][4];
#pragma unroll
      for (int nt8 = 0; nt8 < P::NTW; ++nt8)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[nt8][e] = 0.f;
      // inter-chunk: (r 2^{cum_ex}) S_bf16
#pragma unroll
      for (int kk = 0; kk < P::KS; ++kk) {
        uint32_t a[4];
        decayed_r<N>(a, rs, cum, 16 * rb, kk, -1, lane);
#pragma unroll
        for (int p = 0; p < P::NTW / 2; ++p) {
          uint32_t b[4];
          ldsm_x4(sb + (cw + 16 * p + 8 * (mi >> 1) + mr) * RS + 16 * kk + 8 * (mi & 1), b);
          mma_bf16(o[2 * p], a, b[0], b[1]);
          mma_bf16(o[2 * p + 1], a, b[2], b[3]);
        }
      }
      // intra-chunk: scores of each block j <= rb, times V_j
      for (int j = 0; j <= rb; ++j) {
        uint32_t pa[4];
        if (j < rb) {
          float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
          for (int kk = 0; kk < P::KS; ++kk) {
            uint32_t a[4], b[4];
            decayed_r<N>(a, rs, cum, 16 * rb, kk, 16 * j + 15, lane);
            ldsm_x4(kt + (16 * j + 8 * (mi >> 1) + mr) * RS + 16 * kk + 8 * (mi & 1), b);
            mma_bf16(sc[0], a, b[0], b[1]);
            mma_bf16(sc[1], a, b[2], b[3]);
          }
          pa[0] = pack_bf16(sc[0][0], sc[0][1]);
          pa[1] = pack_bf16(sc[0][2], sc[0][3]);
          pa[2] = pack_bf16(sc[1][0], sc[1][1]);
          pa[3] = pack_bf16(sc[1][2], sc[1][3]);
        } else {
          ldsm_x4(dg + (8 * (mi & 1) + mr) * 24 + 8 * (mi >> 1), pa);
        }
#pragma unroll
        for (int p = 0; p < P::NTW / 2; ++p) {
          uint32_t b[4];
          ldsm_x4_trans(vs + (16 * j + 8 * (mi & 1) + mr) * VS + cw + 16 * p + 8 * (mi >> 1), b);
          mma_bf16(o[2 * p], pa, b[0], b[1]);
          mma_bf16(o[2 * p + 1], pa, b[2], b[3]);
        }
      }
#pragma unroll
      for (int up = 0; up < 2; ++up) {
        const int t = 16 * rb + g + 8 * up;
        if (t < nt) {
          float* orow = out + base + (size_t)(t0 + t) * N + c0 + cw + 2 * q;
#pragma unroll
          for (int nt8 = 0; nt8 < P::NTW; ++nt8)
            *reinterpret_cast<float2*>(orow + 8 * nt8) =
                make_float2(o[nt8][2 * up], o[nt8][2 * up + 1]);
        }
      }
    }
    __syncthreads();  // every warp is done with K~, S_bf16, r and w
    if (more) issue(c + 1, R | W);
    decayed_k<N, true>(kt, ks, cum);  // K^
    __syncthreads();
    if (more) issue(c + 1, K);

    // the state: S <- 2^{cum[C-1]} S + K^^T V, and its bf16 copy
#pragma unroll
    for (int m = 0; m < P::SPW; ++m) {
      const int mt = warp + WARPS * m;
      if (mt < P::SMT) {
        const float d0 = ex2(cum[(C - 1) * CS + 16 * mt + g]);
        const float d1 = ex2(cum[(C - 1) * CS + 16 * mt + g + 8]);
#pragma unroll
        for (int nt8 = 0; nt8 < P::SNT; ++nt8) {
          sacc[m][nt8][0] *= d0;
          sacc[m][nt8][1] *= d0;
          sacc[m][nt8][2] *= d1;
          sacc[m][nt8][3] *= d1;
        }
#pragma unroll
        for (int j = 0; j < P::RB; ++j) {
          uint32_t a[4];
          ldsm_x4_trans(kt + (16 * j + 8 * (mi >> 1) + mr) * RS + 16 * mt + 8 * (mi & 1), a);
#pragma unroll
          for (int p = 0; p < P::SNT / 2; ++p) {
            uint32_t b[4];
            ldsm_x4_trans(vs + (16 * j + 8 * (mi & 1) + mr) * VS + 16 * p + 8 * (mi >> 1), b);
            mma_bf16(sacc[m][2 * p], a, b[0], b[1]);
            mma_bf16(sacc[m][2 * p + 1], a, b[2], b[3]);
          }
        }
#pragma unroll
        for (int nt8 = 0; nt8 < P::SNT; ++nt8)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = 16 * mt + g + 8 * (e >> 1), col = 8 * nt8 + 2 * q + (e & 1);
            sb[col * RS + key] = __float2bfloat16_rn(sacc[m][nt8][e]);
          }
      }
    }
    __syncthreads();  // v may be refilled; S_bf16 is complete
    if (more) issue(c + 1, V);
  }

#pragma unroll
  for (int m = 0; m < P::SPW; ++m) {
    const int mt = warp + WARPS * m;
    if (mt < P::SMT) {
#pragma unroll
      for (int nt8 = 0; nt8 < P::SNT; ++nt8)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = 16 * mt + g + 8 * (e >> 1), col = 8 * nt8 + 2 * q + (e & 1);
          st[(size_t)key * N + c0 + col] = sacc[m][nt8][e];
        }
    }
  }
}

template <int N>
cudaError_t launch(const void* r, const void* k, const void* v, const void* logw,
                   const void* u, void* out, void* state, int bh, int seq,
                   cudaStream_t stream) {
  constexpr int bytes = Plan<N>::BYTES;
  auto kernel = wkv6_mma_kernel<N>;
  // above 48 KB a block's shared memory must be opted into
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(N / Plan<N>::MT, bh);
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(r), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(logw),
      static_cast<const float*>(u), static_cast<float*>(out), static_cast<float*>(state), seq);
  return cudaGetLastError();
}

}  // namespace

// dtype of r, k, v: 1 = bfloat16, the only one this entry takes (fp32 is
// wkv6_fwd_f32's). `state` is read and then overwritten in place. Returns
// the cudaError_t of the launch (cudaErrorInvalidValue for a head size or
// dtype the kernel does not take).
extern "C" int wkv6_fwd_bf16(const void* r, const void* k, const void* v, const void* logw,
                             const void* u, void* out, void* state, int bh, int seq, int n,
                             int dtype, void* stream) {
  if (dtype != 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 16: return launch<16>(r, k, v, logw, u, out, state, bh, seq, s);
    case 32: return launch<32>(r, k, v, logw, u, out, state, bh, seq, s);
    case 64: return launch<64>(r, k, v, logw, u, out, state, bh, seq, s);
    case 128: return launch<128>(r, k, v, logw, u, out, state, bh, seq, s);
    default: return cudaErrorInvalidValue;
  }
}

// The dynamic shared memory a block of head size n is launched with (0 for
// a head size the kernel does not take).
extern "C" int wkv6_fwd_bf16_smem_bytes(int n) {
  switch (n) {
    case 16: return Plan<16>::BYTES;
    case 32: return Plan<32>::BYTES;
    case 64: return Plan<64>::BYTES;
    case 128: return Plan<128>::BYTES;
    default: return 0;
  }
}
