// The gradient of the WKV6 recurrence (RWKV6 "Finch") for NVIDIA Hopper
// (sm_90a), fp32 or bf16 r, k, v, every sum in fp32, on the CUDA cores.
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
//   D_t = rowsum(S_t * G_t) runs backwards as D_{t-1} = D_t - k_t * f_t + r_t * h_t
//   from D_T = rowsum(S_T * dS_T): a reverse cumulative sum that needs neither
//   state at the token whose gradient it gives. Its rounding walks, and the
//   walk's error is shared by every earlier token of the channel, so it adds
//   up coherently in the gradient of the decay's weights (summed over tokens):
//   run over 4096 tokens the w0 gradient of a 4-layer rwkv6-3b read 7.4e-4 off
//   in fp32. So the sum restarts every KD = 64 tokens from the exact
//   rowsum(S_t * G_t), S_t saved by pass h there.
// Layouts: r, k, v, dout, dr, dk, dv (BH, S, N), r/k/v/dr/dk/dv in the
// input dtype, dout fp32; logw, dlogw (BH, S, N) fp32; u, du (BH, N) fp32;
// state0, dstate, dstate0 (BH, N, N) fp32, state0 and dstate may be null
// (zeros). All contiguous and 16-byte aligned; N 16, 32, 64 or 128; any S.
//
// Three passes, each a launch of its own entry point, no atomics, every sum
// in a fixed order (equal inputs give equal bits). A block of passes A and B
// owns MT value columns of one head (o, h's partial and f's partial over
// those columns need only them), as the forward kernel wkv6.cu does; a
// thread holds a JPT x CPT tile of the state in registers:
//   A (wkv6_bwd_h_*), forward in time from S_0: recomputes S and writes the
//     block's partial h over its columns, its columns of S every KD tokens,
//     and its part of rowsum(S_T * dS_T);
//   B (wkv6_bwd_g_*), backward in time from dS_T: carries G; writes dv (whole:
//     it sums over keys, which the block holds), f's partial, the partial of
//     dlogw (its own share of the reverse sum: the running D starts from the
//     block's part of D_T, or every KD tokens of rowsum(S_t * G_t) over its
//     columns, adds r * h's partial from pass A's same columns and takes k *
//     f's partial, which is linear, so the partials add up to the whole),
//     dS_0's columns; block 0 also e_t and du;
//   C (wkv6_bwd_sum_*), elementwise: dr, dk, dlogw from the column tiles'
//     partials and the bonus terms.
// Tokens arrive in rounds of CH, by cp.async into two stages: the next
// round's copies go out while this round runs. bf16 r, k, v stay bf16 in
// shared memory and are widened as they are read.
//
// What bounds it on this card. The bytes: at a training microbatch of
// rwkv6-3b (BH 80, S 4096, N 64, bf16 r/k/v) it must read r, k, v, logw and
// do and write dr, dk, dv and dlogw, 503 MB, 0.150 ms at 3.35 TB/s. The
// recurrence on the CUDA cores: 7 fp32 instructions per (token, key, value
// column) (A: an FFMA for h, an FMUL and an FFMA for S; B: FFMAs for dv and
// f, an FMUL and an FFMA for G), 9.4e9 at that shape, 0.28 ms on 132 SMs x
// 128 lanes at 1.98 GHz. This first design is the simple one: the tensor-core
// form of the chunked gradient, with its column partials kept out of device
// memory, is later work (ROADMAP.md, queue 2).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (kernels/rwkv6/_build.py), one library with the forward
// kernels; entry points wkv6_bwd_{h,g,sum}_{f32,bf16}, bound with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// ---- PTX helpers
// 16 bytes from global to shared memory, asynchronously (src_bytes 16).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// ---- end PTX helpers

// dlogw's reverse sum restarts from the exact rowsum(S_t * G_t) every KD
// tokens (a multiple of every CH)
constexpr int KD = 64;

// A head size's tiling: MT value columns a block, CPT columns and JPT keys a
// thread, CH tokens a round.
template <int N> struct Tile;
template <> struct Tile<16> { static constexpr int MT = 16, CPT = 2, JPT = 2, CH = 16; };
template <> struct Tile<32> { static constexpr int MT = 32, CPT = 4, JPT = 4, CH = 16; };
template <> struct Tile<64> { static constexpr int MT = 32, CPT = 4, JPT = 4, CH = 8; };
template <> struct Tile<128> { static constexpr int MT = 32, CPT = 4, JPT = 8, CH = 8; };

template <int N, typename T>
struct Plan {
  using Tl = Tile<N>;
  static constexpr int MT = Tl::MT, CPT = Tl::CPT, JPT = Tl::JPT, CH = Tl::CH;
  static constexpr int NCP = MT / CPT;      // column groups
  static constexpr int G = N / JPT;         // key groups
  static constexpr int THREADS = NCP * G;
  static constexpr int TILES = N / MT;      // column tiles of a head
  static constexpr int TPT = THREADS / CH;  // lanes of a token in the prep pass
  static constexpr int PN = N + 4;          // a padded row of key partials
  // a stage: r, k, v in T, then logw (e^{logw} once landed), do and pass A's
  // h partial in fp32, CH tokens each
  static constexpr int ROW_T = CH * N * (int)sizeof(T), ROW_F = CH * N * 4;
  static constexpr int R = 0, K = ROW_T, V = 2 * ROW_T, W = 3 * ROW_T, DO = W + ROW_F,
                       HA = DO + ROW_F, STAGE = HA + ROW_F;
  // pass A: two stages, the h partials [CH][NCP][PN]
  static constexpr int BYTES_A = 2 * STAGE + CH * NCP * PN * 4;
  // pass B: two stages, b_t and e_t, the dv partials [CH][G][MT], the f
  // partials [CH][NCP][PN], the partials of a restart's rowsum [NCP][PN]
  static constexpr int BE = 2 * STAGE, DVP = BE + 2 * CH * 4, FP = DVP + CH * G * MT * 4,
                       DR = FP + CH * NCP * PN * 4, BYTES_B = DR + NCP * PN * 4;
  static_assert(KD % CH == 0, "restarts at round boundaries");
  static_assert(N % MT == 0 && MT % CPT == 0 && N % JPT == 0, "whole tiles");
  static_assert(THREADS % 32 == 0 && THREADS <= 1024 && N <= THREADS, "whole warps");
  static_assert(THREADS % CH == 0 && TPT <= 32 && N % TPT == 0, "TPT lanes a token");
  static_assert(ROW_T % 16 == 0 && (CPT == 2 || CPT == 4) && JPT % 2 == 0, "vector loads");
};

// The pointers of every pass, and the sizes.
struct Args {
  const void *r, *k, *v;
  const float *logw, *u, *state0, *dout, *dstate;
  void *dr, *dk, *dv;
  float *dlogw, *du, *dstate0;
  // scratch: the column tiles' partials of h, f and dlogw [TILES][BH][S][N],
  // the parts of rowsum(S_T * dS_T) [TILES][BH][N], e_t [BH][S], S_t after
  // tokens KD - 1, 2 KD - 1, ... short of the last [BH][(S - 1) / KD][N][N]
  float *hpart, *fpart, *dlpart, *dpart, *e, *ckpt;
  int bh, seq;
};

// ---- loads and stores of fp32 or bf16 values
__device__ __forceinline__ float widen(uint32_t bits16) { return __uint_as_float(bits16 << 16); }

template <int K>
__device__ __forceinline__ void ldv(float (&x)[K], const float* p) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int q = 0; q < K / 4; ++q) {
      const float4 a = reinterpret_cast<const float4*>(p)[q];
      x[4 * q] = a.x, x[4 * q + 1] = a.y, x[4 * q + 2] = a.z, x[4 * q + 3] = a.w;
    }
  } else {
    static_assert(K == 2, "2, 4 or 8 values");
    const float2 a = *reinterpret_cast<const float2*>(p);
    x[0] = a.x, x[1] = a.y;
  }
}

template <int K>
__device__ __forceinline__ void ldv(float (&x)[K], const __nv_bfloat16* p) {
#pragma unroll
  for (int q = 0; q < K / 2; ++q) {
    const uint32_t a = reinterpret_cast<const uint32_t*>(p)[q];
    x[2 * q] = widen(a & 0xffffu), x[2 * q + 1] = __uint_as_float(a & 0xffff0000u);
  }
}

__device__ __forceinline__ float ld1(const float* p) { return *p; }
__device__ __forceinline__ float ld1(const __nv_bfloat16* p) {
  return widen(*reinterpret_cast<const uint16_t*>(p));
}

__device__ __forceinline__ void st4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void st4(__nv_bfloat16* p, float a, float b, float c, float d) {
  __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
  q[0] = __floats2bfloat162_rn(a, b);
  q[1] = __floats2bfloat162_rn(c, d);
}

// Round [t0, t0 + nt) of head bh into `stage`: each array's nt rows are one
// contiguous run, copied in 16-byte pieces by all threads; pass B also
// copies pass A's h partial of column tile `tile`.
template <int N, typename T, bool WITH_R>
__device__ __forceinline__ void issue(uint8_t* stage, const Args& a, int bh, int tile, int t0,
                                      int nt) {
  using P = Plan<N, T>;
  const size_t row = (size_t)bh * a.seq + t0;
  const int tb = nt * N * (int)sizeof(T) / 16, fb = nt * N * 4 / 16;
  const uint8_t* src_t[3] = {static_cast<const uint8_t*>(a.r) + row * N * sizeof(T),
                             static_cast<const uint8_t*>(a.k) + row * N * sizeof(T),
                             static_cast<const uint8_t*>(a.v) + row * N * sizeof(T)};
  const float* hrow = a.hpart + ((size_t)tile * a.bh * a.seq + row) * N;
  const uint8_t* src_f[3] = {reinterpret_cast<const uint8_t*>(a.logw + row * N),
                             reinterpret_cast<const uint8_t*>(a.dout + row * N),
                             reinterpret_cast<const uint8_t*>(hrow)};
#pragma unroll
  for (int q = WITH_R ? 0 : 1; q < 3; ++q)
    for (int i = threadIdx.x; i < tb; i += P::THREADS)
      cp_async16(stage + q * P::ROW_T + 16 * i, src_t[q] + 16 * i, 16);
#pragma unroll
  for (int q = 0; q < (WITH_R ? 3 : 2); ++q)
    for (int i = threadIdx.x; i < fb; i += P::THREADS)
      cp_async16(stage + P::W + q * P::ROW_F + 16 * i, src_f[q] + 16 * i, 16);
  cp_async_commit();
}

// e^{logw} in place over the round's nt tokens (expf, the full-accuracy
// form, as the forward kernels take it)
template <int N, typename T>
__device__ __forceinline__ void exp_pass(uint8_t* stage, int nt) {
  float* w = reinterpret_cast<float*>(stage + Plan<N, T>::W);
  for (int i = threadIdx.x; i < nt * N; i += Plan<N, T>::THREADS) w[i] = expf(w[i]);
}

// ---------------------------------------------------------------- pass A
template <int N, typename T>
__global__ void __launch_bounds__(Plan<N, T>::THREADS) wkv6_bwd_h_kernel(const Args a) {
  using P = Plan<N, T>;
  constexpr int MT = P::MT, CPT = P::CPT, JPT = P::JPT, CH = P::CH, NCP = P::NCP,
                THREADS = P::THREADS, PN = P::PN;
  extern __shared__ float4 smem4[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(smem4);
  float* hp = reinterpret_cast<float*>(sm + 2 * P::STAGE);

  const int bh = blockIdx.y, tile = blockIdx.x, c0 = tile * MT, tid = threadIdx.x;
  const int cg = tid % NCP, cc = cg * CPT, j0 = tid / NCP * JPT;
  const int seq = a.seq;
  float s[JPT][CPT];  // S[j0 .. j0 + JPT, c0 + cc .. c0 + cc + CPT]
#pragma unroll
  for (int j = 0; j < JPT; ++j) {
    if (a.state0) {
      ldv<CPT>(s[j], a.state0 + ((size_t)bh * N + j0 + j) * N + c0 + cc);
    } else {
#pragma unroll
      for (int m = 0; m < CPT; ++m) s[j][m] = 0.f;
    }
  }
  const int rounds = (seq + CH - 1) / CH;
  if (rounds > 0) issue<N, T, false>(sm, a, bh, tile, 0, min(CH, seq));
  for (int rd = 0; rd < rounds; ++rd) {
    const int t0 = rd * CH, nt = min(CH, seq - t0);
    uint8_t* st = sm + (rd & 1) * P::STAGE;
    cp_async_wait_all();
    __syncthreads();  // the round has landed; the round before is done with
    exp_pass<N, T>(st, nt);
    __syncthreads();  // e^{logw} is in
    if (rd + 1 < rounds)  // the other stage is free: fetch the next round into it
      issue<N, T, false>(sm + ((rd + 1) & 1) * P::STAGE, a, bh, tile, t0 + CH,
                         min(CH, seq - t0 - CH));
    const T* ks = reinterpret_cast<const T*>(st + P::K);
    const T* vs = reinterpret_cast<const T*>(st + P::V);
    const float* ws = reinterpret_cast<const float*>(st + P::W);
    const float* ds = reinterpret_cast<const float*>(st + P::DO);
#pragma unroll 1
    for (int tt = 0; tt < nt; ++tt) {
      float kk[JPT], ww[JPT], vv[CPT], dd[CPT], hh[JPT];
      ldv<JPT>(kk, ks + tt * N + j0);
      ldv<JPT>(ww, ws + tt * N + j0);
      ldv<CPT>(vv, vs + tt * N + c0 + cc);
      ldv<CPT>(dd, ds + tt * N + c0 + cc);
#pragma unroll
      for (int j = 0; j < JPT; ++j) {
        float h0 = 0.f, h1 = 0.f;
#pragma unroll
        for (int m = 0; m < CPT; ++m) {
          // h reads the state before this token's update
          float& h = m % 2 ? h1 : h0;
          h = fmaf(s[j][m], dd[m], h);
          s[j][m] = fmaf(s[j][m], ww[j], kk[j] * vv[m]);
        }
        hh[j] = h0 + h1;
      }
      float* dst = hp + (tt * NCP + cg) * PN + j0;
#pragma unroll
      for (int j = 0; j < JPT; j += 2) *reinterpret_cast<float2*>(dst + j) = {hh[j], hh[j + 1]};
      const int done = t0 + tt + 1;  // S_{done - 1} is in the registers
      if (done % KD == 0 && done < seq) {
        float* ck = a.ckpt + (((size_t)bh * ((seq - 1) / KD) + done / KD - 1) * N + j0) * N +
                    c0 + cc;
#pragma unroll
        for (int j = 0; j < JPT; ++j) {
#pragma unroll
          for (int m = 0; m < CPT; ++m) ck[(size_t)j * N + m] = s[j][m];
        }
      }
    }
    __syncthreads();  // the partials are in
    // h over the block's columns: the NCP column groups' partials, in order
    for (int i = tid; i < nt * (N / 4); i += THREADS) {
      const int tt = i / (N / 4), j4 = i % (N / 4) * 4;
      float4 h = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int q = 0; q < NCP; ++q) {
        const float4 p = *reinterpret_cast<const float4*>(hp + (tt * NCP + q) * PN + j4);
        h.x += p.x, h.y += p.y, h.z += p.z, h.w += p.w;
      }
      *reinterpret_cast<float4*>(
          a.hpart + (((size_t)tile * a.bh + bh) * seq + t0 + tt) * N + j4) = h;
    }
  }
  if (a.dstate == nullptr) return;  // D_T = 0: pass B starts its sums from zero
  // the block's part of D_T = rowsum(S_T * dS_T), over its columns
  __syncthreads();  // the last round's partials are read
  float dsr[JPT];
#pragma unroll
  for (int j = 0; j < JPT; ++j) {
    float g[CPT];
    ldv<CPT>(g, a.dstate + ((size_t)bh * N + j0 + j) * N + c0 + cc);
    dsr[j] = 0.f;
#pragma unroll
    for (int m = 0; m < CPT; ++m) dsr[j] = fmaf(s[j][m], g[m], dsr[j]);
  }
#pragma unroll
  for (int j = 0; j < JPT; j += 2)
    *reinterpret_cast<float2*>(hp + cg * PN + j0 + j) = {dsr[j], dsr[j + 1]};
  __syncthreads();
  for (int j = tid; j < N; j += THREADS) {
    float d = 0.f;
#pragma unroll
    for (int q = 0; q < NCP; ++q) d += hp[q * PN + j];
    a.dpart[((size_t)tile * a.bh + bh) * N + j] = d;
  }
}

// ---------------------------------------------------------------- pass B
template <int N, typename T>
__global__ void __launch_bounds__(Plan<N, T>::THREADS) wkv6_bwd_g_kernel(const Args a) {
  using P = Plan<N, T>;
  constexpr int MT = P::MT, CPT = P::CPT, JPT = P::JPT, CH = P::CH, NCP = P::NCP, G = P::G,
                THREADS = P::THREADS, PN = P::PN, TPT = P::TPT;
  extern __shared__ float4 smem4[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(smem4);
  float* be = reinterpret_cast<float*>(sm + P::BE);  // b_t [CH], then e_t [CH]
  float* dvp = reinterpret_cast<float*>(sm + P::DVP);
  float* fp = reinterpret_cast<float*>(sm + P::FP);
  float* drs = reinterpret_cast<float*>(sm + P::DR);

  const int bh = blockIdx.y, tile = blockIdx.x, c0 = tile * MT, tid = threadIdx.x;
  const int cg = tid % NCP, cc = cg * CPT, gk = tid / NCP, j0 = gk * JPT;
  const int seq = a.seq;
  float g[JPT][CPT];  // G[j0 .. j0 + JPT, c0 + cc .. c0 + cc + CPT]
#pragma unroll
  for (int j = 0; j < JPT; ++j) {
    if (a.dstate) {
      ldv<CPT>(g[j], a.dstate + ((size_t)bh * N + j0 + j) * N + c0 + cc);
    } else {
#pragma unroll
      for (int m = 0; m < CPT; ++m) g[j][m] = 0.f;
    }
  }
  // the scan threads (tid < N, key tid): the running D of the block's
  // columns, and du (block 0)
  float dsum = 0.f, dusum = 0.f;
  if (tid < N && a.dstate) dsum = a.dpart[((size_t)tile * a.bh + bh) * N + tid];
  // the prep pass: TPT adjacent lanes a token, lane q the keys q, q + TPT, ...
  constexpr int EPT = N / TPT;
  const int et = tid / TPT, eq = tid % TPT;
  float uu[EPT];
#pragma unroll
  for (int i = 0; i < EPT; ++i) uu[i] = a.u[(size_t)bh * N + eq + TPT * i];

  const int rounds = (seq + CH - 1) / CH;
  if (rounds > 0) {
    const int t0 = (rounds - 1) * CH;
    issue<N, T, true>(sm, a, bh, tile, t0, seq - t0);
  }
  for (int it = 0; it < rounds; ++it) {
    const int rd = rounds - 1 - it, t0 = rd * CH, nt = min(CH, seq - t0);
    uint8_t* st = sm + (it & 1) * P::STAGE;
    const T* rs = reinterpret_cast<const T*>(st + P::R);
    const T* ks = reinterpret_cast<const T*>(st + P::K);
    const T* vs = reinterpret_cast<const T*>(st + P::V);
    const float* ws = reinterpret_cast<const float*>(st + P::W);
    const float* ds = reinterpret_cast<const float*>(st + P::DO);
    const float* hs = reinterpret_cast<const float*>(st + P::HA);
    cp_async_wait_all();
    __syncthreads();  // the round has landed; the round before is done with
    exp_pass<N, T>(st, nt);
    {  // b_t = r_t . (u * k_t) and e_t = do_t . v_t, every lane of a warp shuffling
      float b = 0.f, e = 0.f;
      if (et < nt) {
#pragma unroll
        for (int i = 0; i < EPT; ++i) {
          const int x = et * N + eq + TPT * i;
          b = fmaf(ld1(rs + x) * uu[i], ld1(ks + x), b);
          e = fmaf(ds[x], ld1(vs + x), e);
        }
      }
#pragma unroll
      for (int off = TPT / 2; off > 0; off >>= 1) {
        b += __shfl_xor_sync(0xffffffffu, b, off);
        e += __shfl_xor_sync(0xffffffffu, e, off);
      }
      if (eq == 0 && et < nt) be[et] = b, be[CH + et] = e;
    }
    __syncthreads();  // e^{logw}, b_t and e_t are in
    if (it + 1 < rounds)  // the other stage is free: fetch the round before into it
      issue<N, T, true>(sm + ((it + 1) & 1) * P::STAGE, a, bh, tile, t0 - CH, CH);
    // the round ends on a saved state: the block's part of rowsum(S_t * G_t)
    // there (G_t is in the registers), for the scan to restart from
    const bool restart = (t0 + nt) % KD == 0 && t0 + nt < seq;
    if (restart) {
      const float* ck = a.ckpt + (((size_t)bh * ((seq - 1) / KD) + (t0 + nt) / KD - 1) * N + j0) *
                                     N + c0 + cc;
      float d[JPT];
#pragma unroll
      for (int j = 0; j < JPT; ++j) {
        d[j] = 0.f;
#pragma unroll
        for (int m = 0; m < CPT; ++m) d[j] = fmaf(ck[(size_t)j * N + m], g[j][m], d[j]);
      }
#pragma unroll
      for (int j = 0; j < JPT; j += 2)
        *reinterpret_cast<float2*>(drs + cg * PN + j0 + j) = {d[j], d[j + 1]};
    }
#pragma unroll 1
    for (int tt = nt - 1; tt >= 0; --tt) {
      float rr[JPT], kk[JPT], ww[JPT], vv[CPT], dd[CPT], dv[CPT], f[JPT];
      ldv<JPT>(rr, rs + tt * N + j0);
      ldv<JPT>(kk, ks + tt * N + j0);
      ldv<JPT>(ww, ws + tt * N + j0);
      ldv<CPT>(vv, vs + tt * N + c0 + cc);
      ldv<CPT>(dd, ds + tt * N + c0 + cc);
#pragma unroll
      for (int m = 0; m < CPT; ++m) dv[m] = 0.f;
#pragma unroll
      for (int j = 0; j < JPT; ++j) {
        float f0 = 0.f, f1 = 0.f;
#pragma unroll
        for (int m = 0; m < CPT; ++m) {
          // dv and f read G_t, before this token's step back to G_{t-1}
          dv[m] = fmaf(kk[j], g[j][m], dv[m]);
          float& fx = m % 2 ? f1 : f0;
          fx = fmaf(g[j][m], vv[m], fx);
          g[j][m] = fmaf(ww[j], g[j][m], rr[j] * dd[m]);
        }
        f[j] = f0 + f1;
      }
      float* dvd = dvp + (tt * G + gk) * MT + cc;
#pragma unroll
      for (int m = 0; m < CPT; m += 2) *reinterpret_cast<float2*>(dvd + m) = {dv[m], dv[m + 1]};
      float* fd = fp + (tt * NCP + cg) * PN + j0;
#pragma unroll
      for (int j = 0; j < JPT; j += 2) *reinterpret_cast<float2*>(fd + j) = {f[j], f[j + 1]};
    }
    __syncthreads();  // the partials are in
    // dv over all keys (the G key groups' partials in order) plus b_t do_t
    for (int i = tid; i < nt * (MT / 4); i += THREADS) {
      const int tt = i / (MT / 4), m4 = i % (MT / 4) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int q = 0; q < G; ++q) {
        const float4 p = *reinterpret_cast<const float4*>(dvp + (tt * G + q) * MT + m4);
        x.x += p.x, x.y += p.y, x.z += p.z, x.w += p.w;
      }
      const float b = be[tt];
      const float4 d = *reinterpret_cast<const float4*>(ds + tt * N + c0 + m4);
      st4(static_cast<T*>(a.dv) + ((size_t)bh * seq + t0 + tt) * N + c0 + m4,
          fmaf(b, d.x, x.x), fmaf(b, d.y, x.y), fmaf(b, d.z, x.z), fmaf(b, d.w, x.w));
    }
    // key tid: f over the block's columns, and the block's share of dlogw
    // from the running D, token by token backwards
    if (tid < N) {
      const int j = tid;
      if (restart) {
        dsum = 0.f;
#pragma unroll
        for (int q = 0; q < NCP; ++q) dsum += drs[q * PN + j];
      }
      for (int tt = nt - 1; tt >= 0; --tt) {
        float fx = 0.f;
#pragma unroll
        for (int q = 0; q < NCP; ++q) fx += fp[(tt * NCP + q) * PN + j];
        const size_t o = (((size_t)tile * a.bh + bh) * seq + t0 + tt) * N + j;
        const float kj = ld1(ks + tt * N + j), rj = ld1(rs + tt * N + j);
        const float y = kj * fx;
        a.fpart[o] = fx;
        a.dlpart[o] = dsum - y;
        dsum = fmaf(rj, hs[tt * N + j], dsum - y);
        if (tile == 0) dusum = fmaf(rj * kj, be[CH + tt], dusum);
      }
    }
    if (tile == 0 && tid < nt) a.e[(size_t)bh * seq + t0 + tid] = be[CH + tid];
  }
#pragma unroll
  for (int j = 0; j < JPT; ++j) {
    float* p = a.dstate0 + ((size_t)bh * N + j0 + j) * N + c0 + cc;
#pragma unroll
    for (int m = 0; m < CPT; ++m) p[m] = g[j][m];
  }
  if (tile == 0 && tid < N) a.du[(size_t)bh * N + tid] = dusum;
}

// ---------------------------------------------------------------- pass C
constexpr int SUM_THREADS = 256;

template <int N, typename T>
__global__ void __launch_bounds__(SUM_THREADS) wkv6_bwd_sum_kernel(const Args a) {
  constexpr int TILES = Plan<N, T>::TILES;
  const size_t n4 = (size_t)a.bh * a.seq * N / 4;
  const size_t i = (size_t)blockIdx.x * SUM_THREADS + threadIdx.x;
  if (i >= n4) return;
  const size_t x = 4 * i, row = x / N, tiles = (size_t)a.bh * a.seq * N;
  const int j = (int)(x % N), bh = (int)(row / a.seq);
  float4 h = make_float4(0.f, 0.f, 0.f, 0.f), f = h, dl = h;
#pragma unroll
  for (int c = 0; c < TILES; ++c) {
    const float4 p = *reinterpret_cast<const float4*>(a.hpart + c * tiles + x);
    const float4 q = *reinterpret_cast<const float4*>(a.fpart + c * tiles + x);
    const float4 z = *reinterpret_cast<const float4*>(a.dlpart + c * tiles + x);
    h.x += p.x, h.y += p.y, h.z += p.z, h.w += p.w;
    f.x += q.x, f.y += q.y, f.z += q.z, f.w += q.w;
    dl.x += z.x, dl.y += z.y, dl.z += z.z, dl.w += z.w;
  }
  float rr[4], kk[4], uu[4];
  ldv<4>(rr, static_cast<const T*>(a.r) + x);
  ldv<4>(kk, static_cast<const T*>(a.k) + x);
  ldv<4>(uu, a.u + (size_t)bh * N + j);
  const float e = a.e[row];
  st4(static_cast<T*>(a.dr) + x, fmaf(uu[0] * kk[0], e, h.x), fmaf(uu[1] * kk[1], e, h.y),
      fmaf(uu[2] * kk[2], e, h.z), fmaf(uu[3] * kk[3], e, h.w));
  st4(static_cast<T*>(a.dk) + x, fmaf(uu[0] * rr[0], e, f.x), fmaf(uu[1] * rr[1], e, f.y),
      fmaf(uu[2] * rr[2], e, f.z), fmaf(uu[3] * rr[3], e, f.w));
  st4(a.dlogw + x, dl.x, dl.y, dl.z, dl.w);
}

template <int N>
constexpr int tiles_of() { return N / Tile<N>::MT; }

int tiles(int n) {
  switch (n) {
    case 16: return tiles_of<16>();
    case 32: return tiles_of<32>();
    case 64: return tiles_of<64>();
    case 128: return tiles_of<128>();
    default: return 0;
  }
}

// The states a call saves for the restarts of dlogw's sum, a row.
int ckpts(int seq) { return seq > 0 ? (seq - 1) / KD : 0; }

// The scratch a call needs, in floats: three [TILES][BH][S][N] partials,
// [TILES][BH][N], [BH][S] and the saved states [BH][ckpts][N][N].
long long scratch_floats(int bh, int seq, int n) {
  const long long t = tiles(n);
  return 3 * t * bh * seq * n + t * bh * n + (long long)bh * seq +
         (long long)bh * ckpts(seq) * n * n;
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
  const size_t part = (size_t)tiles(n) * bh * seq * n;
  a.hpart = static_cast<float*>(scratch);
  a.fpart = a.hpart + part;
  a.dlpart = a.fpart + part;
  a.dpart = a.dlpart + part;
  a.e = a.dpart + (size_t)tiles(n) * bh * n;
  a.ckpt = a.e + (size_t)bh * seq;
  a.bh = bh, a.seq = seq;
  return a;
}

enum Pass { kH = 0, kG = 1, kSum = 2 };

template <int N, typename T>
int pass_bytes(int pass) {
  return pass == kH ? Plan<N, T>::BYTES_A : pass == kG ? Plan<N, T>::BYTES_B : 0;
}

template <int N, typename T>
cudaError_t launch(int pass, const Args& a, cudaStream_t stream) {
  using P = Plan<N, T>;
  if (pass == kSum) {
    const long long n4 = (long long)a.bh * a.seq * N / 4;
    if (n4 == 0) return cudaSuccess;
    const unsigned blocks = (unsigned)((n4 + SUM_THREADS - 1) / SUM_THREADS);
    auto kernel = wkv6_bwd_sum_kernel<N, T>;
    kernel<<<blocks, SUM_THREADS, 0, stream>>>(a);
    return cudaGetLastError();
  }
  const dim3 grid(P::TILES, a.bh);  // a head's column tiles side by side
  // above 48 KB a block's shared memory must be opted into
  if (pass == kH) {
    auto kernel = wkv6_bwd_h_kernel<N, T>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::BYTES_A);
    if (err != cudaSuccess) return err;
    kernel<<<grid, P::THREADS, P::BYTES_A, stream>>>(a);
  } else {
    auto kernel = wkv6_bwd_g_kernel<N, T>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::BYTES_B);
    if (err != cudaSuccess) return err;
    kernel<<<grid, P::THREADS, P::BYTES_B, stream>>>(a);
  }
  return cudaGetLastError();
}

template <typename T>
int run(int pass, const void* r, const void* k, const void* v, const void* logw, const void* u,
        const void* state0, const void* dout, const void* dstate, void* dr, void* dk, void* dv,
        void* dlogw, void* du, void* dstate0, void* scratch, int bh, int seq, int n,
        void* stream) {
  if (bh < 1 || bh > 65535 || seq < 0) return cudaErrorInvalidValue;
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
// bh, seq, n, stream. Launched in order on one stream: h, then g, then sum.
// Each returns the cudaError_t of its launch (cudaErrorInvalidValue for a
// head size it does not take).
#define WKV6_BWD_ENTRY(NAME, PASS, TYPE)                                                        \
  extern "C" int NAME(const void* r, const void* k, const void* v, const void* logw,           \
                      const void* u, const void* state0, const void* dout, const void* dstate, \
                      void* dr, void* dk, void* dv, void* dlogw, void* du, void* dstate0,      \
                      void* scratch, int bh, int seq, int n, void* stream) {                   \
    return run<TYPE>(PASS, r, k, v, logw, u, state0, dout, dstate, dr, dk, dv, dlogw, du,      \
                     dstate0, scratch, bh, seq, n, stream);                                    \
  }
WKV6_BWD_ENTRY(wkv6_bwd_h_f32, kH, float)
WKV6_BWD_ENTRY(wkv6_bwd_g_f32, kG, float)
WKV6_BWD_ENTRY(wkv6_bwd_sum_f32, kSum, float)
WKV6_BWD_ENTRY(wkv6_bwd_h_bf16, kH, __nv_bfloat16)
WKV6_BWD_ENTRY(wkv6_bwd_g_bf16, kG, __nv_bfloat16)
WKV6_BWD_ENTRY(wkv6_bwd_sum_bf16, kSum, __nv_bfloat16)
#undef WKV6_BWD_ENTRY

// The scratch bytes a call of head size n needs (-1 for a head size the
// kernel does not take).
extern "C" long long wkv6_bwd_scratch_bytes(int bh, int seq, int n) {
  return tiles(n) ? 4 * scratch_floats(bh, seq, n) : -1;
}

// The dynamic shared memory a block of pass `pass` (0 h, 1 g) launches with,
// for head size n and dtype (0 fp32, 1 bf16); 0 for what it does not take.
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
