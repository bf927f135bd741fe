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
// What bounds it on this card: the bytes. At the prefill shapes (BH 160,
// S 2048, N 64) the call moves ~0.4 GB in fp32 (r, k, v, logw in, out and
// the state) and needs ~5e9 FLOP in the recurrence form, far under the
// fp32 rate of the CUDA cores per byte. Run on the CUDA cores, though, the
// recurrence issues 3 fp32 instructions per (token, key, value), and this
// kernel takes several times the byte bound (PERF.md has its time beside
// the bound). The design: one block owns one head and a tile of 32 value
// columns (o[:, m] reads only S[:, m] and v[:, m]),
// so a 40-head model at batch 4 runs 320 blocks on 132 SMs; its 128
// threads are 4 warps, warp g holding rows [g N/4, (g+1) N/4) of the
// block's state columns in registers, one column a lane. Tokens are staged
// 32 at a time in shared memory as fp32 (r, k and e^{logw} for all N keys,
// v for the block's columns), with 16-byte loads; each warp reads them as
// broadcasts, so each (token, key) costs one FFMA for the output, one FMUL
// and one FFMA for the state. Each warp's partial output for the 32 tokens
// goes to shared memory, and after one barrier the block adds the four
// partials and the bonus term d_t v_t (d_t = sum_n r u k, once per token,
// a warp reduction) and writes 32 rows at once. The ragged tail is cut by
// the token count, so the padded tokens of a chunk never touch the state.
// The tensor cores are for bf16 only (wkv6_mma.cu): the fp32 tolerance
// (5e-4) rules out bf16 operands.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (kernels/rwkv6/_build.py), one library with
// wkv6_mma.cu; entry point wkv6_fwd_f32, bound with ctypes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int CH = 32;  // tokens staged per round
constexpr int G = 4;    // warps (key groups) per block

template <int N>
__host__ __device__ constexpr int cols() { return N < 32 ? N : 32; }  // value columns per block

template <int N>
__host__ __device__ constexpr int threads() { return G * cols<N>(); }

template <int N>
__host__ __device__ constexpr int smem_floats() {
  // r, k, w for all keys; v, and the G partial outputs, for the block's
  // columns; u; the bonus term d per token
  return 3 * CH * N + CH * cols<N>() + G * CH * cols<N>() + N + CH;
}

// Copy n_el floats of src (16-byte aligned, n_el a multiple of 4) to dst,
// one 16-byte vector a thread per pass.
template <int THREADS>
__device__ __forceinline__ void stage(float* dst, const float* src, int n_el) {
  for (int i = threadIdx.x * 4; i < n_el; i += THREADS * 4)
    *reinterpret_cast<float4*>(dst + i) = *reinterpret_cast<const float4*>(src + i);
}

template <int N>
__global__ void __launch_bounds__(threads<N>())
    wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v,
                const float* __restrict__ logw, const float* __restrict__ u,
                float* __restrict__ out, float* __restrict__ state, int seq) {
  constexpr int MT = cols<N>(), THREADS = threads<N>(), JPT = N / G;
  static_assert(JPT % 4 == 0 && MT % 4 == 0, "float4 key groups, vector loads of v");
  extern __shared__ float4 smem4[];
  float* rs = reinterpret_cast<float*>(smem4);
  float* ks = rs + CH * N;
  float* ws = ks + CH * N;
  float* vs = ws + CH * N;
  float* yp = vs + CH * MT;
  float* us = yp + G * CH * MT;
  float* ds = us + N;

  const int bh = blockIdx.y, c0 = blockIdx.x * MT;
  const int tid = threadIdx.x, m = tid % MT, g = tid / MT, j0 = g * JPT;
  const int lane = tid % 32, warp = tid / 32;
  const size_t base = (size_t)bh * seq * N;
  float* st = state + (size_t)bh * N * N;

  float s[JPT];  // S[j0 .. j0 + JPT, c0 + m]
#pragma unroll
  for (int j = 0; j < JPT; ++j) s[j] = st[(size_t)(j0 + j) * N + c0 + m];
  for (int i = tid; i < N; i += THREADS) us[i] = u[(size_t)bh * N + i];

  for (int t0 = 0; t0 < seq; t0 += CH) {
    const int nt = min(CH, seq - t0);
    const size_t row0 = base + (size_t)t0 * N;
    __syncthreads();  // the previous round's buffers have been read
    stage<THREADS>(rs, r + row0, nt * N);
    stage<THREADS>(ks, k + row0, nt * N);
    stage<THREADS>(ws, logw + row0, nt * N);
    for (int i = tid * 4; i < nt * MT; i += THREADS * 4) {
      const int tt = i / MT, mm = i % MT;
      *reinterpret_cast<float4*>(vs + i) =
          *reinterpret_cast<const float4*>(v + row0 + (size_t)tt * N + c0 + mm);
    }
    __syncthreads();
    for (int i = tid; i < nt * N; i += THREADS) ws[i] = expf(ws[i]);  // decay e^{logw}
    // the bonus term d_t = sum_n r u k: a warp per token, lanes over keys
    for (int tt = warp; tt < nt; tt += THREADS / 32) {
      float d = 0.f;
      for (int n = lane; n < N; n += 32) d = fmaf(rs[tt * N + n] * us[n], ks[tt * N + n], d);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
      if (lane == 0) ds[tt] = d;
    }
    __syncthreads();
    for (int tt = 0; tt < nt; ++tt) {
      const float vm = vs[tt * MT + m];
      const float4* r4 = reinterpret_cast<const float4*>(rs + tt * N + j0);
      const float4* k4 = reinterpret_cast<const float4*>(ks + tt * N + j0);
      const float4* w4 = reinterpret_cast<const float4*>(ws + tt * N + j0);
      float y0 = 0.f, y1 = 0.f, y2 = 0.f, y3 = 0.f;
#pragma unroll
      for (int q = 0; q < JPT / 4; ++q) {
        const float4 rr = r4[q], kk = k4[q], ww = w4[q];
        // o reads the state before this token's update
        y0 = fmaf(rr.x, s[4 * q + 0], y0);
        y1 = fmaf(rr.y, s[4 * q + 1], y1);
        y2 = fmaf(rr.z, s[4 * q + 2], y2);
        y3 = fmaf(rr.w, s[4 * q + 3], y3);
        s[4 * q + 0] = fmaf(s[4 * q + 0], ww.x, kk.x * vm);
        s[4 * q + 1] = fmaf(s[4 * q + 1], ww.y, kk.y * vm);
        s[4 * q + 2] = fmaf(s[4 * q + 2], ww.z, kk.z * vm);
        s[4 * q + 3] = fmaf(s[4 * q + 3], ww.w, kk.w * vm);
      }
      yp[(g * CH + tt) * MT + m] = (y0 + y1) + (y2 + y3);
    }
    __syncthreads();
    for (int i = tid; i < nt * MT; i += THREADS) {
      const int tt = i / MT, mm = i % MT;
      float o = ds[tt] * vs[i];
#pragma unroll
      for (int gg = 0; gg < G; ++gg) o += yp[(gg * CH + tt) * MT + mm];
      out[row0 + (size_t)tt * N + c0 + mm] = o;
    }
  }
#pragma unroll
  for (int j = 0; j < JPT; ++j) st[(size_t)(j0 + j) * N + c0 + m] = s[j];
}

template <int N>
cudaError_t launch(const void* r, const void* k, const void* v, const void* logw,
                   const void* u, void* out, void* state, int bh, int seq,
                   cudaStream_t stream) {
  constexpr int bytes = smem_floats<N>() * (int)sizeof(float);
  auto kernel = wkv6_kernel<N>;
  // above 48 KB (N 128) a block's shared memory must be opted into
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(N / cols<N>(), bh);
  kernel<<<grid, threads<N>(), bytes, stream>>>(
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
    case 16: return smem_floats<16>() * (int)sizeof(float);
    case 32: return smem_floats<32>() * (int)sizeof(float);
    case 64: return smem_floats<64>() * (int)sizeof(float);
    case 128: return smem_floats<128>() * (int)sizeof(float);
    default: return 0;
  }
}
