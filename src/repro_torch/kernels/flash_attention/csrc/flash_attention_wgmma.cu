// Flash attention forward on Hopper's tensor cores (sm_90a), for bf16 q/k/v:
// wgmma for both products, K/V tiles by TMA into a ring of shared-memory
// stages with mbarriers, one producer warp and two consumer warpgroups.
//
// Replaces, for bf16 inputs, the TPU kernel `flash_attention_bhsd` (body
// `_flash_kernel`) of src/repro/kernels/flash_attention/kernel.py; fp32
// inputs keep the CUDA-core kernel of flash_attention.cu (see kernel.py).
// It computes the function of `_flash_kernel`:
//   * q (BHq, Sq, Dh), k/v (BHkv, Sk, Dh), bf16, contiguous; query head h
//     reads kv head h / (BHq / BHkv); Dh in 16..128, a multiple of 16;
//   * s = q.k * scale, masked where k_pos > q_pos (causal) or
//     k_pos <= q_pos - window, positions from 0 for q and k alike, with the
//     FINITE mask value -1e30;
//   * online softmax in fp32, o = acc / max(l, 1e-30), cast to bf16;
//   * kv tiles entirely in the future or behind the window are skipped.
// One departure from the reference's arithmetic, shared by every
// tensor-core flash kernel: the softmax weights P are rounded to bf16 before
// O += P.V (`_flash_kernel` multiplies fp32 P by fp32 V). The error this
// adds (a relative 2^-9 per weight) stays inside the reference's bf16
// tolerance of 2.5e-2. The products q.k are exact in fp32 (bf16 x bf16), as
// in the reference; only the order of the sums differs.
//
// What bounds it: at the prefill shapes (Dh 128, S 2048, causal) attention
// does about Dh/2 FLOP per byte of q/k/v/o, far above the H100's ~295
// FLOP/byte ridge, so the bound is the operations (4*Dh FLOP per live
// (q, k) pair) at the bf16 tensor-core rate. The design goes for that rate:
//   * S = Q.K^T on wgmma m64n128k16 (bf16 in, fp32 accumulator in
//     registers): each consumer warpgroup owns 64 query rows of the block's
//     128; Q is loaded once per block; K, stored as it is (keys x Dh), is
//     the K-major B operand, so nothing is transposed by hand.
//   * The softmax runs on the accumulator fragment: a row's values sit in
//     the 4 lanes of a quad, so row max and sum take two shuffles. It is
//     the CUDA-core side of the kernel and costs about as much as the
//     products, so it is kept lean: only tiles on a diagonal, at a window
//     edge or at the ragged end run the (branch-free) masked copy; the
//     others fold the scale into one FFMA per score ahead of 2^x on the
//     special-function unit.
//   * A warpgroup's tile runs S, softmax, P.V in turn; the two consumer
//     warpgroups interleave, one's softmax beside the other's products.
//   * O += P.V on wgmma with A = P from registers: the fp32 S fragment,
//     rounded to bf16, is already in the A-operand layout (the m64 x k16 A
//     fragment matches two n8 blocks of the accumulator), and V (keys x Dh)
//     is the MN-major B operand (the wgmma transpose bit).
//   * K and V arrive by TMA, 128 keys a tile, into STAGES shared-memory
//     stages with a full and an empty mbarrier each: warpgroup 0's first
//     thread keeps loads in flight while the consumers compute
//     (setmaxnreg moves registers from the producer to the consumers).
// Layout in shared memory: every tile is stored as panels of 64 bf16
// columns (128 bytes a row) in TMA's 128-byte swizzle, the layout the wgmma
// descriptors name. Head widths below 64 and between 64 and 128 are padded
// to 64 and 128 by the TMA box itself: columns past Dh are out of bounds
// and filled with zeros, which add nothing to q.k and give output columns
// that are not stored. Ragged lengths are the same: keys past Sk arrive as
// zeros (3-d tensor maps, so the fill is per head) and score -inf (weight
// exactly 0); rows past Sq are computed on zeros and not stored.
// The finite -1e30 matters under a window: a row's first live tile can be
// fully masked for that row; its weights are then exp(0) = 1 (m = -1e30),
// finite in bf16, and the first real key's correction exp(-1e30 - m) is
// exactly 0, as in the reference. A row with no key in reach at all
// (Sq > Sk + window) lies outside the function's contract: like the Pallas
// kernel, this one then averages V over its block's live tiles, so the
// answer depends on the tile size (attention_ref averages over all keys).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC, with flash_attention.cu, into one library
// (kernels/flash_attention/_build.py); no -lcuda: the driver's
// cuTensorMapEncodeTiled is reached through cudaGetDriverEntryPoint.
// Entry point flash_fwd_bf16, bound with ctypes.

#include <cuda.h>  // CUtensorMap and the driver API's types (no driver calls are linked)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;        // query rows per block: two consumer warpgroups of 64
constexpr int BK = 128;        // keys per kv tile
constexpr int STAGES = 2;      // depth of the K/V ring
constexpr int THREADS = 384;   // warpgroup 0 loads, warpgroups 1 and 2 compute
constexpr int PANEL = 64;      // bf16 columns in one 128-byte swizzled panel
constexpr int ROW_BYTES = 128;
constexpr int ATOM_BYTES = 8 * ROW_BYTES;  // 8 rows: one period of the swizzle
constexpr float MASKED = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// ------------------------------------------------------------ PTX helpers
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// arrive once and add `bytes` to the transactions the current phase waits for
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of a 3-d tensor map (coordinates innermost first) into shared
// memory; completion is counted in bytes on `bar`
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma matrix descriptor of an operand in 128-byte swizzle: start address,
// leading and stride byte offsets (16-byte units), layout type 1 (B128)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins the registers of an accumulator at this point of the program, so
// that the compiler moves no read or write of them across a wgmma wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x 128, fp32) {=, +=} A (64 x 16 bf16, smem, K-major) . B (128 x 16 bf16, smem,
// K-major)^T; `accumulate` 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                               int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 64, fp32) += A (64 x 16 bf16, registers) . B (16 x 64 bf16, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, fp32) += A (64 x 16 bf16, registers) . B (16 x 128 bf16, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// ------------------------------------------------- consumer building blocks
// The accumulator fragment of m64nN: thread (warp w, lane l) of a warpgroup
// holds rows r0 = 16w + l/4 and r0 + 8, columns 8j + cq and 8j + cq + 1
// (cq = 2 (l % 4)) of every n8 block j, in registers 4j + 2i + e (row
// r0 + 8i, column 8j + cq + e). A row lives in the 4 lanes of a quad.

// issue S = Q K^T (64 rows x BK keys; not waited for): Dh / 16 steps of
// k16; a step advances 32 bytes along the swizzled rows of a panel, 4 steps
// make a panel
template <int DHP>
__device__ __forceinline__ void issue_qk(float (&sc)[BK / 2], uint32_t q_rows, uint32_t k_tile) {
#pragma unroll
  for (int kk = 0; kk < DHP / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    wgmma_ss_n128(sc, sw128_desc(q_rows + (kk / 4) * (BQ * ROW_BYTES) + off, 16, ATOM_BYTES),
                  sw128_desc(k_tile + (kk / 4) * (BK * ROW_BYTES) + off, 16, ATOM_BYTES), kk > 0);
  }
}

// issue O += P V (not waited for): 16 keys a step, each 16 rows of 128
// bytes of every panel of V; the panels (64 columns of Dh each) lie
// BK * 128 bytes apart
template <int DHP>
__device__ __forceinline__ void issue_pv(float (&acc)[DHP / 2], const uint32_t (&pa)[BK / 16][4],
                                         uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t db = sw128_desc(v_tile + kk * 16 * ROW_BYTES, BK * ROW_BYTES, ATOM_BYTES);
    if constexpr (DHP == 64) {
      wgmma_rs_n64(acc, pa[kk], db);
    } else {
      wgmma_rs_n128(acc, pa[kk], db);
    }
  }
}

// 2^x on the special-function unit (relative error about 2^-22; 2^-inf
// and 2^-1e30 are +0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Where the masks fall in a tile of keys k0 .. k0 + BK - 1 for this
// thread's elements: element offset o = 8j + e (key k0 + cq + o) of row
// r0 + 8i is no key when o > key_last (past Sk), and masked when
// o > hi[i] (causal: in the row's future) or o <= lo[i] (behind the window).
struct TileMask {
  int key_last, hi[2], lo[2];
};

__device__ __forceinline__ TileMask tile_mask(int k0, int r0, int cq, int sk, int causal,
                                              int window) {
  TileMask t;
  t.key_last = sk - 1 - k0 - cq;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i - k0 - cq;
    t.hi[i] = causal ? row : BK;
    t.lo[i] = window > 0 ? row - window : -1;
  }
  return t;
}

// One online-softmax step on the scores of a tile: scale (base 2), mask
// (MASKED tiles only: those that reach past Sk, past the first row's
// diagonal or behind the last row's window), new row maxima m, the
// correction corr = 2^(m_old - m_new) of the rows' earlier sums, the
// weights in place of the scores, and this thread's part of the row sums l.
template <bool MASKED_TILE>
__device__ __forceinline__ void online_softmax(float (&sc)[BK / 2], float (&m)[2], float (&l)[2],
                                               float (&corr)[2], const TileMask& mask,
                                               float scale_log2) {
  float mx[2] = {MASKED, MASKED};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x = sc[4 * j + 2 * i + e];
        if constexpr (MASKED_TILE) {
          // selects, not branches: o is a constant once the loops unroll
          const int o = 8 * j + e;
          x = (o > mask.hi[i] || o <= mask.lo[i]) ? MASKED : x * scale_log2;
          x = o > mask.key_last ? -INFINITY : x;  // ragged tail: no key here
          sc[4 * j + 2 * i + e] = x;
        }
        mx[i] = fmaxf(mx[i], x);
      }
  float neg_m[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    // unmasked scores are scaled only now: scale > 0 keeps the maximum
    const float m_new = fmaxf(m[i], MASKED_TILE ? mx[i] : mx[i] * scale_log2);
    corr[i] = fast_exp2(m[i] - m_new);
    m[i] = m_new;
    neg_m[i] = -m_new;
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = sc[4 * j + 2 * i + e];
        x = fast_exp2(MASKED_TILE ? x + neg_m[i] : fmaf(x, scale_log2, neg_m[i]));
        rs[i] += x;
      }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + rs[i];
}

// the softmax step, masked or not as the tile needs
__device__ __forceinline__ void softmax_step(float (&sc)[BK / 2], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], bool need_mask,
                                             const TileMask& mask, float scale_log2) {
  if (need_mask) {
    online_softmax<true>(sc, m, l, corr, mask, scale_log2);
  } else {
    online_softmax<false>(sc, m, l, corr, mask, scale_log2);
  }
}

// P in bf16, in the A layout of m64 x k16: keys 16kk .. 16kk + 15 are the
// n8 blocks 2kk and 2kk + 1 of the S fragment
__device__ __forceinline__ void pack_p(const float (&sc)[BK / 2], uint32_t (&pa)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    pa[kk][0] = pack_bf16x2(sc[8 * kk + 0], sc[8 * kk + 1]);
    pa[kk][1] = pack_bf16x2(sc[8 * kk + 2], sc[8 * kk + 3]);
    pa[kk][2] = pack_bf16x2(sc[8 * kk + 4], sc[8 * kk + 5]);
    pa[kk][3] = pack_bf16x2(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

template <int N>
__device__ __forceinline__ void rescale(float (&acc)[N], const float (&corr)[2]) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      acc[4 * j + 2 * i] *= corr[i];
      acc[4 * j + 2 * i + 1] *= corr[i];
    }
}

// Shared memory of a block, in bytes from a 1024-byte aligned base: the Q
// tile, STAGES K tiles, STAGES V tiles (each NP panels of rows x 128 bytes),
// then the mbarriers.
template <int DHP>
struct Smem {
  static constexpr int NP = DHP / PANEL;
  static constexpr int Q_PANEL = BQ * ROW_BYTES, KV_PANEL = BK * ROW_BYTES;
  static constexpr int Q_BYTES = NP * Q_PANEL, KV_BYTES = NP * KV_PANEL;
  static constexpr int K0 = Q_BYTES, V0 = K0 + STAGES * KV_BYTES;
  static constexpr int BARS = V0 + STAGES * KV_BYTES;  // q_full, full[STAGES], empty[STAGES]
  static constexpr int BYTES = BARS + 8 * (1 + 2 * STAGES) + 1024;  // + slack to align
};

// grid (ceil(Sq / BQ), BHq), THREADS threads, Smem<DHP>::BYTES dynamic shared
// memory. DHP: Dh padded to 64 or 128. scale_log2 = log2(e) / sqrt(Dh): the
// softmax runs in base 2 (exp2(x log2 e) = exp(x)).
template <int DHP>
__global__ void __launch_bounds__(THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
                   float* __restrict__ lse, int sq, int sk, int dh, int group, int causal,
                   int window, float scale_log2) {
  using L = Smem<DHP>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;  // the swizzle's period
  const uint32_t q_full = base + L::BARS;
  auto full = [&](int s) { return base + L::BARS + 8u * (1 + s); };
  auto empty = [&](int s) { return base + L::BARS + 8u * (1 + STAGES + s); };

  const int n_q = (sq + BQ - 1) / BQ;
  const int q0 = (n_q - 1 - (int)blockIdx.x) * BQ;  // longest rows launch first
  const int bh = blockIdx.y;

  // the live kv tiles: none entirely in the future, none entirely behind
  // the window, for any row of this block
  const int q_last = min(q0 + BQ, sq) - 1;
  int t_begin = 0, t_end = (sk + BK - 1) / BK;
  if (causal) t_end = min(t_end, q_last / BK + 1);
  if (window > 0 && q0 - window + 1 > 0) t_begin = (q0 - window + 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);                      // the producer's expect_tx
      mbar_init(empty(s), THREADS - 128);         // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ------------------------------------------------ producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, L::Q_BYTES);
      for (int p = 0; p < L::NP; ++p)
        tma_load_3d(base + p * L::Q_PANEL, &tm_q, q_full, p * PANEL, q0, bh);
      const int bkv = bh / group;
      for (int t = t_begin, it = 0; t < t_end; ++t, ++it) {
        const int s = it % STAGES;
        mbar_wait(empty(s), ((it / STAGES) & 1) ^ 1);  // the first round passes at once
        mbar_expect_tx(full(s), 2 * L::KV_BYTES);
        for (int p = 0; p < L::NP; ++p) {
          tma_load_3d(base + L::K0 + s * L::KV_BYTES + p * L::KV_PANEL, &tm_k, full(s),
                      p * PANEL, t * BK, bkv);
          tma_load_3d(base + L::V0 + s * L::KV_BYTES + p * L::KV_PANEL, &tm_v, full(s),
                      p * PANEL, t * BK, bkv);
        }
      }
    }
  } else {
    // ----------------------------------------------- consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int c = threadIdx.x / 128 - 1;  // rows 64c .. 64c + 63 of the block
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int r0 = q0 + 64 * c + 16 * warp + lane / 4;
    const int cq = 2 * (lane % 4);
    const int wg_first = q0 + 64 * c, wg_last = min(q0 + 64 * c + 63, sq - 1);
    const uint32_t q_rows = base + c * 64 * ROW_BYTES;

    float acc[DHP / 2];
#pragma unroll
    for (int i = 0; i < DHP / 2; ++i) acc[i] = 0.f;
    float m_i[2] = {MASKED, MASKED}, l_i[2] = {0.f, 0.f};  // l_i: this thread's part of the row sum
    float sc[BK / 2], corr[2];
    uint32_t pa[BK / 16][4];

    mbar_wait(q_full, 0);
    for (int it = 0; it < t_end - t_begin; ++it) {
      const int s = it % STAGES;
      const int k0 = (t_begin + it) * BK;
      mbar_wait(full(s), (it / STAGES) & 1);
      wgmma_fence();
      issue_qk<DHP>(sc, q_rows, base + L::K0 + s * L::KV_BYTES);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      // only tiles that reach past Sk, past the first row's diagonal or
      // behind the last row's window need the mask
      const bool need_mask = k0 + BK > sk || (causal && k0 + BK - 1 > wg_first) ||
                             (window > 0 && k0 <= wg_last - window);
      softmax_step(sc, m_i, l_i, corr, need_mask, tile_mask(k0, r0, cq, sk, causal, window),
                   scale_log2);
      rescale(acc, corr);
      pack_p(sc, pa);
      fence_regs(acc);
      wgmma_fence();
      issue_pv<DHP>(acc, pa, base + L::V0 + s * L::KV_BYTES);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(empty(s));  // this thread is done with the stage
    }

    // o = acc / max(l, 1e-30), as acc times the reciprocal, for rows below
    // Sq and columns below Dh
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float l = l_i[i];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float inv = 1.f / fmaxf(l, 1e-30f);
      const int row = r0 + 8 * i;
      if (row >= sq) continue;
      // the row's log-sum-exp for the backward: m and l are in base 2 of
      // the scaled scores
      if (lse != nullptr && cq == 0)
        lse[(size_t)bh * sq + row] = (m_i[i] + log2f(fmaxf(l, 1e-30f))) * LN2;
      __nv_bfloat16* orow = o + ((size_t)bh * sq + row) * dh;
#pragma unroll
      for (int j = 0; j < DHP / 8; ++j) {
        const int col = 8 * j + cq;
        if (col < dh)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(acc[4 * j + 2 * i] * inv, acc[4 * j + 2 * i + 1] * inv);
      }
    }
  }
}

// ------------------------------------------------------------------ host
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, reached through the runtime (so the
// library needs no -lcuda); null if the driver does not offer it.
EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A (bh, s, dh) bf16 tensor as a 3-d tensor map whose box is one 64-column
// panel of `rows` rows of one head, in 128-byte swizzle; boxes that reach
// past dh or s are filled with zeros.
bool encode(EncodeTiled enc, CUtensorMap* map, const void* ptr, int bh, int s, int dh, int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)dh, (cuuint64_t)(s > 0 ? s : 1), (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)dh * 2, (cuuint64_t)(s > 0 ? s : 1) * dh * 2};
  const cuuint32_t box[3] = {PANEL, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DHP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse, int bhq,
                   int bhkv, int sq, int sk, int dh, int causal, int window, float scale,
                   cudaStream_t stream) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!encode(enc, &tm_q, q, bhq, sq, dh, BQ) || !encode(enc, &tm_k, k, bhkv, sk, dh, BK) ||
      !encode(enc, &tm_v, v, bhkv, sk, dh, BK))
    return cudaErrorInvalidValue;
  constexpr int bytes = Smem<DHP>::BYTES;
  auto kernel = flash_wgmma_kernel<DHP>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + BQ - 1) / BQ, bhq);
  kernel<<<grid, THREADS, bytes, stream>>>(tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o),
                                           static_cast<float*>(lse), sq, sk, dh, bhq / bhkv,
                                           causal, window, scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o bf16, contiguous, 16-byte aligned. lse: null, or (BHq, Sq)
// fp32 for each row's log-sum-exp of its scaled scores (the backward's
// input). window <= 0 means no window. Returns the cudaError_t of the
// launch (cudaErrorInvalidValue for a head width the kernel does not take
// or a tensor map the driver refuses, cudaErrorNotSupported without
// cuTensorMapEncodeTiled).
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v, void* o, void* lse,
                              int bhq, int bhkv, int sq, int sk, int dh, int causal, int window,
                              float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh < 16 || dh > 128 || dh % 16) return cudaErrorInvalidValue;
  if (dh <= 64)
    return launch<64>(q, k, v, o, lse, bhq, bhkv, sq, sk, dh, causal, window, scale, s);
  return launch<128>(q, k, v, o, lse, bhq, bhkv, sq, sk, dh, causal, window, scale, s);
}
