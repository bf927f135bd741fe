// Host versions of sm90.cuh's PTX helpers (the block between its
// `PTX helpers` marks) for tools/sm90_emu.py, on the EmuBlock of
// emu_cuda.h.

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)((const uint8_t*)p - emu_smem());
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  EmuBarrier* b = emu_block->bar(bar);
  std::lock_guard<std::mutex> g(b->m);
  b->count = b->pending = count;
  b->tx = 0;
  b->phase = 0;
}
__device__ __forceinline__ void mbar_fence_init() {}
template <int N> __device__ __forceinline__ void reg_dealloc() {}
template <int N> __device__ __forceinline__ void reg_alloc() {}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  EmuBarrier* b = emu_block->bar(bar);
  std::lock_guard<std::mutex> g(b->m);
  b->tx += bytes;
  b->pending -= 1;
  b->check();
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  EmuBarrier* b = emu_block->bar(bar);
  std::lock_guard<std::mutex> g(b->m);
  b->pending -= 1;
  if (b->pending < 0) { fprintf(stderr, "mbarrier %u over-arrived\n", bar); abort(); }
  b->check();
}
inline void emu_complete_tx(uint32_t bar, long long bytes) {
  EmuBarrier* b = emu_block->bar(bar);
  std::lock_guard<std::mutex> g(b->m);
  b->tx -= bytes;
  b->check();
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  EmuBarrier* b = emu_block->bar(bar);
  std::unique_lock<std::mutex> g(b->m);
  if (!b->cv.wait_for(g, std::chrono::seconds(20), [&] { return (b->phase & 1) != parity; })) {
    fprintf(stderr, "deadlock: thread %u block (%u,%u) waits on mbarrier %u parity %u\n",
            threadIdx.x, blockIdx.x, blockIdx.y, bar, parity);
    abort();
  }
}

inline uint32_t emu_swz(uint32_t a) { return a ^ (((a >> 7) & 7) << 4); }

inline void emu_tma(uint32_t dst, const CUtensorMap* m, uint32_t bar, const int* c) {
  if (dst % 128) { fprintf(stderr, "TMA destination %u not 128-byte aligned\n", dst); abort(); }
  uint64_t n = 1;
  for (int i = 0; i < m->rank; ++i) n *= m->box[i];
  for (uint64_t e = 0; e < n; ++e) {
    uint64_t rest = e, off = 0;
    bool in = true;
    for (int i = 0; i < m->rank; ++i) {
      const long long x = (long long)c[i] + (long long)(rest % m->box[i]);
      rest /= m->box[i];
      if (x < 0 || x >= (long long)m->dims[i]) in = false;
      else off += x * m->strides[i];
    }
    uint32_t a = dst + (uint32_t)(e * m->elem);
    if (m->swizzle == CU_TENSOR_MAP_SWIZZLE_128B) a = emu_swz(a);
    if (a + m->elem > emu_block->smem_bytes) { fprintf(stderr, "TMA past shared memory\n"); abort(); }
    if (in) memcpy(emu_smem() + a, m->ptr + off, m->elem);
    else memset(emu_smem() + a, 0, m->elem);
  }
  emu_complete_tx(bar, (long long)(n * m->elem));
}
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  if (map->rank != 3) abort();
  const int c[3] = {c0, c1, c2};
  emu_tma(dst, map, bar, c);
}
__device__ __forceinline__ void tma_load_1d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0) {
  if (map->rank != 1) abort();
  const int c[1] = {c0};
  emu_tma(dst, map, bar, c);
}
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {}
__device__ __forceinline__ void wgmma_commit() {}
template <int N> __device__ __forceinline__ void wgmma_wait() {}
template <int N> __device__ __forceinline__ void fence_regs(float (&)[N]) {}

struct EmuDesc { uint32_t start, lbo, sbo; };
inline EmuDesc emu_desc(uint64_t d) {
  if ((d >> 62) != 1) { fprintf(stderr, "descriptor not in 128-byte swizzle\n"); abort(); }
  return {(uint32_t)(d & 0x3FFF) << 4, (uint32_t)((d >> 16) & 0x3FFF) << 4,
          (uint32_t)((d >> 32) & 0x3FFF) << 4};
}
inline float emu_bf(uint32_t a) {  // a bf16 of shared memory at byte address a
  if (a + 2 > emu_block->smem_bytes) { fprintf(stderr, "operand past shared memory\n"); abort(); }
  uint16_t h; memcpy(&h, emu_smem() + a, 2);
  return __bfloat162float(__nv_bfloat16{h});
}
// K-major operand: element (row, k) of a 16-deep slice
inline float emu_kmajor(const EmuDesc& d, int row, int k) {
  return emu_bf(emu_swz(d.start + (row / 8) * d.sbo + (row % 8) * 128 + 2 * k));
}
// MN-major operand: element (k, n)
inline float emu_mnmajor(const EmuDesc& d, int k, int n) {
  return emu_bf(emu_swz(d.start + (n / 64) * d.lbo + (k / 8) * d.sbo + (k % 8) * 128 + 2 * (n % 64)));
}
inline float emu_lo(uint32_t x) { return __bfloat162float(__nv_bfloat16{(uint16_t)(x & 0xffff)}); }
inline float emu_hi(uint32_t x) { return __bfloat162float(__nv_bfloat16{(uint16_t)(x >> 16)}); }

// this thread's fragment of D (64 x N) from A(r, k) and B(k, n)
template <int N, typename FA, typename FB>
inline void emu_mma(float* d, int accumulate, FA a, FB b) {
  const int t = threadIdx.x % 128, w = t / 32, l = t % 32;
  const int r0 = 16 * w + l / 4, cq = 2 * (l % 4);
  for (int j = 0; j < N / 8; ++j)
    for (int i = 0; i < 2; ++i)
      for (int e = 0; e < 2; ++e) {
        const int r = r0 + 8 * i, n = 8 * j + cq + e;
        float s = 0.f;
        for (int k = 0; k < 16; ++k) s += a(r, k) * b(k, n);
        float& x = d[4 * j + 2 * i + e];
        x = accumulate ? x + s : s;
      }
}
template <int N>
inline void emu_ss(float* d, uint64_t da, uint64_t db, int accumulate) {
  const EmuDesc A = emu_desc(da), B = emu_desc(db);
  emu_mma<N>(d, accumulate, [&](int r, int k) { return emu_kmajor(A, r, k); },
             [&](int k, int n) { return emu_kmajor(B, n, k); });
}
template <int N>
inline void emu_rs(float* d, const uint32_t (&a)[4], uint64_t db) {
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  for (int i = 0; i < 4; ++i) emu_block->a_slots[wg][t][i] = a[i];
  emu_block->wg_sync[wg]->arrive_and_wait();
  // A (64 x 16) from the warpgroup's fragments
  float A[64][16];
  for (int u = 0; u < 128; ++u) {
    const int w = u / 32, l = u % 32, r = 16 * w + l / 4, cq = 2 * (l % 4);
    const uint32_t* s = emu_block->a_slots[wg][u];
    A[r][cq] = emu_lo(s[0]); A[r][cq + 1] = emu_hi(s[0]);
    A[r + 8][cq] = emu_lo(s[1]); A[r + 8][cq + 1] = emu_hi(s[1]);
    A[r][cq + 8] = emu_lo(s[2]); A[r][cq + 9] = emu_hi(s[2]);
    A[r + 8][cq + 8] = emu_lo(s[3]); A[r + 8][cq + 9] = emu_hi(s[3]);
  }
  emu_block->wg_sync[wg]->arrive_and_wait();
  const EmuDesc B = emu_desc(db);
  emu_mma<N>(d, 1, [&](int r, int k) { return A[r][k]; },
             [&](int k, int n) { return emu_mnmajor(B, k, n); });
}
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  emu_ss<128>(d, da, db, acc);
}
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  emu_ss<64>(d, da, db, acc);
}
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  emu_rs<64>(d, a, db);
}
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  emu_rs<128>(d, a, db);
}
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return (uint32_t)v.x.x | ((uint32_t)v.y.x << 16);
}
__device__ __forceinline__ float fast_exp2(float x) { return exp2f(x); }
