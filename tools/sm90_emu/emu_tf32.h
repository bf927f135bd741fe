// Host versions of sm80_tf32.cuh's PTX helpers (the block between its
// `PTX helpers` marks) for tools/sm90_emu.py --fp32, on the EmuBlock of
// emu_cuda.h. cp.async: copies queued by the thread and made at its
// wait_group (zeros past src_bytes), the latest a copy may land, so a read
// of a stage before its wait sees garbage. ldmatrix and mma.sync: the 32
// lanes of a warp exchange their operands through per-warp slots, one
// barrier an exchange (the slots alternate by its parity, so a lane writes
// a set only after every lane has read it). mma.sync reads each operand
// with its 13 low bits cleared and rounds its sum toward zero, as the
// tensor core does (tools/flash_fp32_ab.py's probe: its results lie a
// mean 0.62 ulp toward zero of the exact sums): the 8 products and the
// accumulator summed in double, then rounded to fp32 toward zero.

struct EmuCopy {
  void* dst;
  const void* src;
  int bytes, src_bytes;
};
inline thread_local std::vector<EmuCopy> emu_copies;
inline thread_local unsigned emu_exchanges = 0;

inline void emu_check_smem(const void* p, int bytes, const char* what) {
  const long long off = (const uint8_t*)p - emu_block->smem;
  if (off < 0 || off + bytes > (long long)emu_block->smem_bytes || off % bytes) {
    fprintf(stderr, "%s: shared offset %lld (%d bytes) outside the block's %zu or unaligned\n",
            what, off, bytes, emu_block->smem_bytes);
    abort();
  }
}

inline void emu_cp_async(void* dst, const void* src, int bytes, int src_bytes) {
  emu_check_smem(dst, bytes, "cp.async");
  if ((uintptr_t)src % bytes || src_bytes < 0 || src_bytes > bytes) {
    fprintf(stderr, "cp.async: source %p unaligned or src_bytes %d\n", src, src_bytes);
    abort();
  }
  emu_copies.push_back({dst, src, bytes, src_bytes});
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  emu_cp_async(dst, src, 16, src_bytes);
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  emu_cp_async(dst, src, 4, src_bytes);
}
__device__ __forceinline__ void cp_async_commit() {}
__device__ __forceinline__ void cp_async_wait_all() {
  for (const EmuCopy& c : emu_copies) {
    std::memcpy(c.dst, c.src, c.src_bytes);
    std::memset((uint8_t*)c.dst + c.src_bytes, 0, c.bytes - c.src_bytes);
  }
  emu_copies.clear();
}
__device__ __forceinline__ void prefetch_l2(const void*) {}

// this lane's 8 words of the current exchange's set, and the set
inline uint32_t* emu_slots(int lane_of_set = -1) {
  const int w = threadIdx.x / 32, par = emu_exchanges & 1;
  const int l = lane_of_set < 0 ? (int)(threadIdx.x % 32) : lane_of_set;
  return &emu_block->xchg[((w * 2 + par) * 32 + l) * 8];
}
inline void emu_warp_barrier() { emu_block->warp_sync[threadIdx.x / 32]->arrive_and_wait(); }

__device__ __forceinline__ void ldsm_x4(const void* row, uint32_t (&x)[4]) {
  emu_check_smem(row, 16, "ldmatrix row");
  std::memcpy(emu_slots(), &row, sizeof(row));
  emu_warp_barrier();
  const int l = threadIdx.x % 32;
  for (int i = 0; i < 4; ++i) {
    const uint32_t* r;
    std::memcpy(&r, emu_slots(8 * i + l / 4), sizeof(r));
    x[i] = r[l % 4];
  }
  ++emu_exchanges;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  uint32_t* mine = emu_slots();
  for (int i = 0; i < 4; ++i) mine[i] = a[i];
  mine[4] = b0;
  mine[5] = b1;
  emu_warp_barrier();
  const int l = threadIdx.x % 32, g = l / 4, t = l % 4;
  auto tf32 = [](uint32_t u) { return (double)__uint_as_float(u & 0xffffe000u); };
  // A (r, c): lane (r % 8) 4 + c % 4, register (r >= 8) + 2 (c >= 4);
  // B (k, n): lane 4 n + k % 4, register b0 (k < 4) or b1
  auto A = [&](int r, int c) { return tf32(emu_slots((r % 8) * 4 + c % 4)[(r >= 8) + 2 * (c >= 4)]); };
  auto B = [&](int k, int n) { return tf32(emu_slots(4 * n + k % 4)[4 + (k >= 4)]); };
  for (int e = 0; e < 4; ++e) {
    const int r = g + 8 * (e >> 1), n = 2 * t + (e & 1);
    double s = d[e];
    for (int k = 0; k < 8; ++k) s += A(r, k) * B(k, n);
    float f = (float)s;
    if (std::fabs((double)f) > std::fabs(s)) f = std::nextafter(f, 0.f);
    d[e] = f;
  }
  ++emu_exchanges;
}

__device__ __forceinline__ float ex2(float x) { return exp2f(x); }
