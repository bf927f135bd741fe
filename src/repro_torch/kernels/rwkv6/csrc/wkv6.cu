// WKV6 recurrence (RWKV6 "Finch") for NVIDIA Hopper (sm_90a), from a given
// state to the final one, for fp32 r, k, v on the CUDA cores. bf16 r, k, v
// go to the tensor-core kernel of wkv6_mma.cu (kernels/rwkv6/kernel.py,
// KERNELS).
//
// Replaces the TPU kernel `wkv6_bhsn` (body `_wkv_kernel`) of
// src/repro/kernels/rwkv6/kernel.py. Per head, with an N x N state S that
// maps keys to values:
//   o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
//   S_t = diag(e^{logw_t}) S_{t-1} + k_t^T v_t
//   * r, k, v (BH, S, N), fp32; logw (BH, S, N) and u (BH, N) fp32;
//     all contiguous and 16-byte aligned;
//   * state (BH, N, N) fp32, read as the initial state and overwritten with
//     the final one; out (BH, S, N) fp32;
//   * N is 16, 32, 64 or 128; S is any length.
// The Pallas kernel walks 32-token chunks in matrix form and clamps the
// within-chunk cumulative decay at -30, which is wrong once the decay of a
// chunk passes -30 (rwkv6's own decay_base init reaches that). This kernel
// runs the recurrence itself, token by token, so it is exact for any decay
// and needs no clamp; it computes what repro.kernels.rwkv6.ref.wkv6_ref
// computes, and it takes and returns the state, which the Pallas kernel
// does not (prefill hands the state to the decode cache).
//
// What bounds it on this card. The bytes: at the prefill shapes (BH 160,
// S 2048, N 64) the call moves 422 MB (r, k, v, logw in, out and the state),
// 0.126 ms at 3.35 TB/s. And the issue of the recurrence itself: three fp32
// instructions per (token, key, value column) (an FFMA for o, an FMUL for
// k v and an FFMA for S), 4.0e9 lanes' worth at those shapes, 0.120 ms on
// 132 SMs x 128 fp32 lanes at 1.98 GHz before a single shared load. So the
// kernel can come near the byte bound only if its copies hide under the
// recurrence and its shared loads and bookkeeping stay few beside the FMAs.
//
// The design (PERF.md §6 has the clock64() split of each version beside
// its time; tools/wkv6_sections.py measures them):
//   * a block owns MT value columns of one head and runs all its tokens
//     (o[:, m] reads only S[:, m] and v[:, m]); a thread holds CPT = 2
//     adjacent columns for JPT = 8 keys of the state in registers, so each
//     float4 of r, k and e^{logw} it reads from shared memory feeds 2
//     columns: 7 shared loads per 48 FP instructions a token. MT is 32 at
//     N 64 (128 threads, 320 blocks at BH 160: 3 on 56 SMs, 2 on 76):
//     16-column tiles (640 blocks, 5 an SM against a mean of 4.85) balance
//     the SMs but pay the e^{logw} pass and the copies once per 16 columns
//     instead of 32, and ran 15 % slower; 64-column tiles ran slower too,
//     and splitting only the tiles past the last full wave into halves
//     gained nothing.
//   * a ring of STAGES = 2 stages of CH = 16 tokens in shared memory, each
//     with its own mbarrier. A stage is four 1D bulk copies (cp.async.bulk,
//     the copy engine; completion counted in bytes on the stage's
//     mbarrier): a head's r, k, logw and v rows for CH tokens are one
//     contiguous run each, v with all N columns (its MT columns alone are
//     a run a row, and a bulk copy a row from the lanes of one warp cost
//     that warp ~1,600 cycles a round, which the block then waited for).
//     Lane 0 of each of the first four warps issues one of the four. The
//     next round's copies go out right after this round's first barrier,
//     when their stage is free, so they land while the block runs this
//     round's tokens (the wait at the mbarrier is ~3 % of a round); no
//     thread holds a value in transit in its registers. The ragged tail
//     copies only its nt tokens' bytes and never reads past S x N.
//   * e^{logw} once per staged element for the block (expf, the
//     full-accuracy form: exact to an ulp or two at any decay, where
//     __expf's error grows with |logw|), into a buffer of its own, in the same
//     pass as the bonus term d_t = sum_n r u k (TPT adjacent lanes a token,
//     a shuffle reduction over them); then a barrier, the token loop, a
//     barrier, and the output pass (the G key groups' partial outputs from
//     shared memory, plus d_t v_t).
//   * the padded tokens of a ragged round never touch the state.
// Why not the chunked form on the tensor cores with three TF32 products
// (as the fp32 flash kernel does): the bf16 chunked mma.sync kernel
// (wkv6_mma.cu) itself runs at 0.405 ms at these shapes, bound by the
// instructions of its exact diagonal blocks; three products would triple its
// product instructions and fp32 tiles double its bytes, above what the
// recurrence reaches. bf16 operands cannot hold the fp32 tolerance (5e-4).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (kernels/rwkv6/_build.py), one library with
// wkv6_mma.cu; entry point wkv6_fwd_f32, bound with ctypes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int STAGES = 2;

// A head size's tiling: MT value columns a block, CPT columns and JPT keys
// a thread, CH tokens a stage.
template <int N> struct Tile;
template <> struct Tile<16> { static constexpr int MT = 16, CPT = 1, JPT = 4, CH = 32; };
template <> struct Tile<32> { static constexpr int MT = 16, CPT = 2, JPT = 4, CH = 32; };
template <> struct Tile<64> { static constexpr int MT = 32, CPT = 2, JPT = 8, CH = 16; };
template <> struct Tile<128> { static constexpr int MT = 16, CPT = 2, JPT = 8, CH = 16; };

template <int N>
struct Layout {
  using T = Tile<N>;
  static constexpr int MT = T::MT, CPT = T::CPT, JPT = T::JPT, CH = T::CH;
  static constexpr int NCP = MT / CPT;     // column groups
  static constexpr int G = N / JPT;        // key groups
  static constexpr int THREADS = NCP * G;
  static constexpr int GQ = N / 4;         // float4s of a token's keys
  static constexpr int TPT = THREADS / CH; // threads of a token in the e^{logw} pass
  // one stage: r, k, logw and v for all keys and columns (four runs of
  // CH N floats, one bulk copy each); d_t
  static constexpr int STAGE = 4 * CH * N + CH;
  // the ring, e^{logw} of the current round, the G partial outputs, u
  static constexpr int FLOATS = STAGES * STAGE + CH * N + CH * G * MT + N;
  static constexpr int BYTES = FLOATS * 4 + STAGES * 8;  // and the mbarriers
  static_assert(JPT % 4 == 0 && MT % 4 == 0 && N % MT == 0 && N % JPT == 0, "float4 tiles");
  static_assert(CPT == 1 || CPT == 2 || CPT == 4, "a column group is a float, float2 or float4");
  static_assert(THREADS % 32 == 0 && THREADS <= 1024, "whole warps");
  static_assert(CH % 4 == 0 && THREADS % CH == 0 && TPT <= 32 && GQ % TPT == 0,
                "TPT adjacent lanes a token");
};

// ------------------------------------------------------------ PTX helpers
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// arrive once and add `bytes` to the transactions the current phase waits for
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` has completed; a copy that never
// lands traps after ~2^32 cycles (a few seconds) instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const long long start = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (!done && clock64() - start > (1ll << 32)) __trap();
  } while (!done);
}

// `bytes` (a multiple of 16, both ends 16-byte aligned) from global to this
// block's shared memory by the copy engine, counted on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
// ---------------------------------------------------------- end PTX helpers

template <int CPT>
__device__ __forceinline__ void load_cols(float (&x)[CPT], const float* p) {
  if constexpr (CPT == 1) {
    x[0] = *p;
  } else if constexpr (CPT == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    x[0] = a.x, x[1] = a.y;
  } else {
    const float4 a = *reinterpret_cast<const float4*>(p);
    x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
  }
}

template <int CPT>
__device__ __forceinline__ void store_cols(float* p, const float (&x)[CPT]) {
  if constexpr (CPT == 1) {
    *p = x[0];
  } else if constexpr (CPT == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  }
}

// Round `c`'s nt tokens into `stage`: r, k, logw and v (all N columns: one
// run, where the block's MT columns alone would be a copy a row) in one bulk
// copy each, one a warp from lane 0 of the block's four warps (two each
// where a block has two: a warp that issues waits for the copy engine to
// take its copies, so they are spread); warp
// 0's announces the stage's bytes first. A copy may land before they are
// announced: the mbarrier's transaction count may go below zero, and its
// phase cannot complete before warp 0's arrival.
template <int N>
__device__ __forceinline__ void issue(float* stage, uint64_t* bar, const float* r, const float* k,
                                      const float* v, const float* logw, size_t row0, int nt) {
  using L = Layout<N>;
  constexpr int CH = L::CH, W = L::THREADS / 32 < 4 ? L::THREADS / 32 : 4;  // issuing warps
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 != 0 || warp >= W) return;
  const uint32_t bytes = nt * N * 4;
  if (warp == 0) mbar_expect_tx(bar, 4 * bytes);
  const float* src[4] = {r, k, logw, v};
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (q % W == warp) bulk_copy(stage + q * CH * N, src[q] + row0, bytes, bar);
}

template <int N>
__global__ void __launch_bounds__(Layout<N>::THREADS)
    wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v,
                const float* __restrict__ logw, const float* __restrict__ u,
                float* __restrict__ out, float* __restrict__ state, int seq) {
  using L = Layout<N>;
  constexpr int MT = L::MT, CPT = L::CPT, JPT = L::JPT, CH = L::CH, G = L::G,
                THREADS = L::THREADS, GQ = L::GQ;
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  float* ws = ring + STAGES * L::STAGE;  // e^{logw} of the current round
  float* yp = ws + CH * N;               // [CH][G][MT] partial outputs
  float* us = yp + CH * G * MT;
  uint64_t* full = reinterpret_cast<uint64_t*>(us + N);

  const int bh = blockIdx.y, c0 = blockIdx.x * MT;
  const int tid = threadIdx.x;
  const int cc = (tid % L::NCP) * CPT, g = tid / L::NCP, j0 = g * JPT;
  const size_t base = (size_t)bh * seq * N;
  float* st = state + (size_t)bh * N * N;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(full + s, 1);  // warp 0's expect_tx
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  float s[JPT][CPT];  // S[j0 .. j0 + JPT, c0 + cc .. c0 + cc + CPT]
#pragma unroll
  for (int j = 0; j < JPT; ++j) load_cols<CPT>(s[j], st + (size_t)(j0 + j) * N + c0 + cc);
  for (int i = tid; i < N; i += THREADS) us[i] = u[(size_t)bh * N + i];
  __syncthreads();
  // the e^{logw} pass: TPT adjacent lanes a token, lane q of them the key
  // float4s q, q + TPT, ... (u's stay in registers)
  constexpr int TPT = L::TPT, GPT = GQ / TPT;
  const int et = tid / TPT, eq = tid % TPT;
  float4 u4[GPT];
#pragma unroll
  for (int i = 0; i < GPT; ++i) u4[i] = reinterpret_cast<const float4*>(us)[eq + TPT * i];
  const int rounds = (seq + CH - 1) / CH;
  for (int c = 0; c < STAGES - 1 && c < rounds; ++c)
    issue<N>(ring + c * L::STAGE, full + c, r, k, v, logw, base + (size_t)c * CH * N,
             min(CH, seq - c * CH));

  for (int t0 = 0; t0 < seq; t0 += CH) {
    const int c = t0 / CH, nt = min(CH, seq - t0), sn = c % STAGES;
    const float* rs = ring + sn * L::STAGE;
    const float* ks = rs + CH * N;
    const float* lws = ks + CH * N;
    const float* vs = lws + CH * N;
    float* ds = const_cast<float*>(vs) + CH * N;
    mbar_wait(full + sn, (c / STAGES) & 1);
    __syncwarp();  // the stage has landed
    // e^{logw} once per element and d_t = sum_n r u k, TPT lanes a token
    if (et < nt) {
      float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < GPT; ++i) {
        const int e = et * GQ + eq + TPT * i;
        const float4 lw = reinterpret_cast<const float4*>(lws)[e];
        const float4 rr = reinterpret_cast<const float4*>(rs)[e];
        const float4 kk = reinterpret_cast<const float4*>(ks)[e];
        reinterpret_cast<float4*>(ws)[e] =
            make_float4(expf(lw.x), expf(lw.y), expf(lw.z), expf(lw.w));
        d[0] = fmaf(rr.x * u4[i].x, kk.x, d[0]);
        d[1] = fmaf(rr.y * u4[i].y, kk.y, d[1]);
        d[2] = fmaf(rr.z * u4[i].z, kk.z, d[2]);
        d[3] = fmaf(rr.w * u4[i].w, kk.w, d[3]);
      }
      float dt = (d[0] + d[1]) + (d[2] + d[3]);
      // the TPT lanes of a token are adjacent and all take this branch
#pragma unroll
      for (int off = TPT / 2; off > 0; off >>= 1)
        dt += __shfl_xor_sync(TPT == 32 ? 0xffffffffu : ((1u << TPT) - 1) << (tid % 32 / TPT * TPT),
                              dt, off);
      if (eq == 0) ds[et] = dt;
    }
    __syncthreads();  // e^{logw} and d_t are in; the round before is written out
    // the stage of the round before is free: fetch round c + STAGES - 1 into it
    if (c + STAGES - 1 < rounds) {
      const int cn = c + STAGES - 1;
      issue<N>(ring + (cn % STAGES) * L::STAGE, full + cn % STAGES, r, k, v, logw,
               base + (size_t)cn * CH * N, min(CH, seq - cn * CH));
    }
    auto step = [&](int tt) {
      const float4* r4 = reinterpret_cast<const float4*>(rs + tt * N + j0);
      const float4* k4 = reinterpret_cast<const float4*>(ks + tt * N + j0);
      const float4* w4 = reinterpret_cast<const float4*>(ws + tt * N + j0);
      float vm[CPT], y0[CPT], y1[CPT];
      load_cols<CPT>(vm, vs + tt * N + c0 + cc);
#pragma unroll
      for (int m = 0; m < CPT; ++m) y0[m] = y1[m] = 0.f;
#pragma unroll
      for (int q = 0; q < JPT / 4; ++q) {
        const float4 rr = r4[q], kk = k4[q], ww = w4[q];
        const float rj[4] = {rr.x, rr.y, rr.z, rr.w}, kj[4] = {kk.x, kk.y, kk.z, kk.w},
                    wj[4] = {ww.x, ww.y, ww.z, ww.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
#pragma unroll
          for (int m = 0; m < CPT; ++m) {
            // o reads the state before this token's update
            float& y = e % 2 ? y1[m] : y0[m];
            y = fmaf(rj[e], s[4 * q + e][m], y);
            s[4 * q + e][m] = fmaf(s[4 * q + e][m], wj[e], kj[e] * vm[m]);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < CPT; ++m) y0[m] += y1[m];
      store_cols<CPT>(yp + (tt * G + g) * MT + cc, y0);
    };
    if (nt == CH) {
#pragma unroll
      for (int tt = 0; tt < CH; ++tt) step(tt);
    } else {
#pragma unroll 1
      for (int tt = 0; tt < nt; ++tt) step(tt);
    }
    __syncthreads();  // the partial outputs are in
    for (int i = tid; i < nt * (MT / 4); i += THREADS) {
      const int tt = i / (MT / 4), m4 = i % (MT / 4) * 4;
      const float d = ds[tt];
      const float4 vv = *reinterpret_cast<const float4*>(vs + tt * N + c0 + m4);
      float4 o = make_float4(d * vv.x, d * vv.y, d * vv.z, d * vv.w);
#pragma unroll
      for (int gg = 0; gg < G; ++gg) {
        const float4 p = *reinterpret_cast<const float4*>(yp + (tt * G + gg) * MT + m4);
        o.x += p.x, o.y += p.y, o.z += p.z, o.w += p.w;
      }
      *reinterpret_cast<float4*>(out + base + (size_t)(t0 + tt) * N + c0 + m4) = o;
    }
  }
#pragma unroll
  for (int j = 0; j < JPT; ++j) store_cols<CPT>(st + (size_t)(j0 + j) * N + c0 + cc, s[j]);
}

template <int N>
cudaError_t launch(const void* r, const void* k, const void* v, const void* logw,
                   const void* u, void* out, void* state, int bh, int seq,
                   cudaStream_t stream) {
  using L = Layout<N>;
  auto kernel = wkv6_kernel<N>;
  // above 48 KB a block's shared memory must be opted into
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid(N / L::MT, bh);  // a head's column tiles side by side
  kernel<<<grid, L::THREADS, L::BYTES, stream>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v),
      static_cast<const float*>(logw), static_cast<const float*>(u),
      static_cast<float*>(out), static_cast<float*>(state), seq);
  return cudaGetLastError();
}

}  // namespace

// dtype of r, k, v: 0 = float32, the only one this entry takes (bf16 is
// wkv6_fwd_bf16's). `state` is read and then overwritten in place. Returns
// the cudaError_t of the launch (cudaErrorInvalidValue for a head size or
// dtype the kernel does not take).
extern "C" int wkv6_fwd_f32(const void* r, const void* k, const void* v, const void* logw,
                            const void* u, void* out, void* state, int bh, int seq, int n,
                            int dtype, void* stream) {
  if (dtype != 0) return cudaErrorInvalidValue;
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
extern "C" int wkv6_fwd_f32_smem_bytes(int n) {
  switch (n) {
    case 16: return Layout<16>::BYTES;
    case 32: return Layout<32>::BYTES;
    case 64: return Layout<64>::BYTES;
    case 128: return Layout<128>::BYTES;
    default: return 0;
  }
}
