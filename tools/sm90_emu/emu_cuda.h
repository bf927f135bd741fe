// Host-thread emulation of the CUDA surface the flash, WKV6 and lease
// kernels use (tools/sm90_emu.py): the keywords, bf16, the vector types, the
// runtime and driver types, blocks of std::threads with their barriers,
// votes, shuffles, atomics and launches. Warp-level calls take whole warps
// (their masks are not read).
#pragma once
#include <barrier>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <functional>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>
#include <math.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __grid_constant__
#define __launch_bounds__(...)

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint3e { unsigned x = 0, y = 0, z = 0; };
inline thread_local uint3e threadIdx, blockIdx;
inline dim3 blockDim, gridDim;

struct float2 { float x, y; } __attribute__((aligned(8)));
struct float4 { float x, y, z, w; } __attribute__((aligned(16)));
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline uint32_t __float_as_uint(float f) { uint32_t u; std::memcpy(&u, &f, 4); return u; }
inline float __uint_as_float(uint32_t u) { float f; std::memcpy(&f, &u, 4); return f; }
struct uint4 { unsigned x, y, z, w; };
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }

// bf16, round to nearest even
struct __nv_bfloat16 { uint16_t x; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline __nv_bfloat16 emu_f2bf(float f) {
  uint32_t u; std::memcpy(&u, &f, 4);
  if ((u & 0x7fffffff) > 0x7f800000) return {(uint16_t)((u >> 16) | 0x40)};
  u += 0x7fff + ((u >> 16) & 1);
  return {(uint16_t)(u >> 16)};
}
inline float __bfloat162float(__nv_bfloat16 b) {
  uint32_t u = (uint32_t)b.x << 16; float f; std::memcpy(&f, &u, 4); return f;
}
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) { return {emu_f2bf(a), emu_f2bf(b)}; }
inline __nv_bfloat16 __float2bfloat16_rn(float a) { return emu_f2bf(a); }

// runtime
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorNotSupported = 801 };
typedef void* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <typename K> cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
inline cudaError_t cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) { memset(p, v, n); return 0; }
enum cudaDriverEntryPointQueryResult { cudaDriverEntryPointSuccess = 0 };
enum { cudaEnableDefault = 0 };

// driver types
typedef int CUresult;
enum { CUDA_SUCCESS = 0 };
typedef uint32_t cuuint32_t;
typedef uint64_t cuuint64_t;
enum CUtensorMapDataType { CU_TENSOR_MAP_DATA_TYPE_FLOAT32 = 7, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 = 9 };
enum CUtensorMapInterleave { CU_TENSOR_MAP_INTERLEAVE_NONE = 0 };
enum CUtensorMapSwizzle { CU_TENSOR_MAP_SWIZZLE_NONE = 0, CU_TENSOR_MAP_SWIZZLE_128B = 3 };
enum CUtensorMapL2promotion { CU_TENSOR_MAP_L2_PROMOTION_NONE = 0, CU_TENSOR_MAP_L2_PROMOTION_L2_256B = 3 };
enum CUtensorMapFloatOOBfill { CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE = 0 };
struct CUtensorMap {
  const uint8_t* ptr;
  int rank, elem, swizzle;
  uint64_t dims[5], strides[5];  // strides in bytes, strides[0] = elem
  uint32_t box[5];
};

inline CUresult emu_encode_tiled(CUtensorMap* m, CUtensorMapDataType dt, cuuint32_t rank, void* p,
                                 const cuuint64_t* dims, const cuuint64_t* strides,
                                 const cuuint32_t* box, const cuuint32_t* elem_strides,
                                 CUtensorMapInterleave, CUtensorMapSwizzle sw,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill) {
  if (p == nullptr || ((uintptr_t)p % 16) != 0 || rank < 1 || rank > 5) return 1;
  m->ptr = (const uint8_t*)p;
  m->rank = rank;
  m->elem = dt == CU_TENSOR_MAP_DATA_TYPE_FLOAT32 ? 4 : 2;
  m->swizzle = sw;
  m->strides[0] = m->elem;
  for (unsigned i = 0; i < rank; ++i) {
    m->dims[i] = dims[i];
    m->box[i] = box[i];
    if (box[i] == 0 || box[i] > 256 || elem_strides[i] != 1) return 1;
    if (i > 0) {
      m->strides[i] = strides[i - 1];
      if (strides[i - 1] % 16) return 1;
    }
  }
  if ((box[0] * m->elem) % 16) return 1;
  if (sw == CU_TENSOR_MAP_SWIZZLE_128B && box[0] * m->elem > 128) return 1;
  return 0;
}
inline cudaError_t cudaGetDriverEntryPoint(const char*, void** p, int,
                                           cudaDriverEntryPointQueryResult* r) {
  *p = (void*)&emu_encode_tiled;
  *r = cudaDriverEntryPointSuccess;
  return 0;
}

// ------------------------------------------------------------ the block
struct EmuBarrier {
  std::mutex m;
  std::condition_variable cv;
  int count = 0, pending = 0;
  long long tx = 0;
  uint32_t phase = 0;
  void check() {
    if (pending == 0 && tx == 0) {
      ++phase;
      pending = count;
      cv.notify_all();
    }
  }
};

struct EmuBlock {
  uint8_t* smem;
  size_t smem_bytes;
  std::barrier<> sync;
  std::mutex bars_m;
  std::map<uint32_t, std::unique_ptr<EmuBarrier>> bars;
  // per warpgroup: the rs A fragments and a barrier
  uint32_t a_slots[8][128][4];
  std::vector<std::unique_ptr<std::barrier<>>> wg_sync;
  // per warp: shuffle slots (float and int), and two sets (by the parity of
  // the exchange) of 8 words a lane for ldmatrix and mma.sync (emu_tf32.h)
  float shfl[64][32];
  int ishfl[64][32];
  std::vector<uint32_t> xchg;
  std::vector<std::unique_ptr<std::barrier<>>> warp_sync;
  // per thread: its predicate for __syncthreads_and
  std::vector<int> preds;
  EmuBlock(size_t bytes, int threads)
      : smem_bytes(bytes), sync(threads), xchg((threads + 31) / 32 * 2 * 32 * 8),
        preds(threads) {
    smem = (uint8_t*)aligned_alloc(1024, (bytes + 1023) / 1024 * 1024 + 1024);
    memset(smem, 0xA5, bytes);  // garbage, as on the card
    for (int w = 0; w < (threads + 127) / 128; ++w) wg_sync.emplace_back(new std::barrier<>(128));
    for (int w = 0; w < (threads + 31) / 32; ++w) warp_sync.emplace_back(new std::barrier<>(32));
  }
  ~EmuBlock() { free(smem); }
  EmuBarrier* bar(uint32_t a) {
    std::lock_guard<std::mutex> g(bars_m);
    auto& b = bars[a];
    if (!b) b.reset(new EmuBarrier);
    return b.get();
  }
};
inline thread_local EmuBlock* emu_block = nullptr;
inline uint8_t* emu_smem() { return emu_block->smem; }

inline void __syncthreads() { emu_block->sync.arrive_and_wait(); }

inline int __syncthreads_and(int pred) {
  emu_block->preds[threadIdx.x] = pred;
  emu_block->sync.arrive_and_wait();
  int all = 1;
  for (int v : emu_block->preds) all = all && v;
  emu_block->sync.arrive_and_wait();
  return all;
}

inline void __syncwarp(unsigned = 0xffffffffu) {
  emu_block->warp_sync[threadIdx.x / 32]->arrive_and_wait();
}

template <typename T> inline T __ldg(const T* p) { return *p; }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline unsigned long long atomicAdd(unsigned long long* p, unsigned long long v) {
  return __atomic_fetch_add(p, v, __ATOMIC_RELAXED);
}

inline int __shfl_xor_sync(unsigned, int v, int mask) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  emu_block->ishfl[w][l] = v;
  emu_block->warp_sync[w]->arrive_and_wait();
  const int r = emu_block->ishfl[w][l ^ mask];
  emu_block->warp_sync[w]->arrive_and_wait();
  return r;
}

inline unsigned __ballot_sync(unsigned, int pred) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  emu_block->ishfl[w][l] = pred != 0;
  emu_block->warp_sync[w]->arrive_and_wait();
  unsigned bits = 0;
  for (int i = 0; i < 32; ++i) bits |= (unsigned)emu_block->ishfl[w][i] << i;
  emu_block->warp_sync[w]->arrive_and_wait();
  return bits;
}

inline int __all_sync(unsigned mask, int pred) { return __ballot_sync(mask, pred) == 0xffffffffu; }

inline float __shfl_xor_sync(unsigned, float v, int mask) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  emu_block->shfl[w][l] = v;
  emu_block->warp_sync[w]->arrive_and_wait();
  const float r = emu_block->shfl[w][l ^ mask];
  emu_block->warp_sync[w]->arrive_and_wait();
  return r;
}

template <typename K, typename... A>
void emu_launch(K kernel, dim3 grid, int threads, int bytes, cudaStream_t, A... args) {
  gridDim = grid;
  blockDim = dim3(threads);
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      EmuBlock blk(bytes, threads);
      std::vector<std::thread> ts;
      for (int t = 0; t < threads; ++t)
        ts.emplace_back([&, t] {
          threadIdx.x = t;
          blockIdx.x = bx;
          blockIdx.y = by;
          emu_block = &blk;
          kernel(args...);
        });
      for (auto& t : ts) t.join();
    }
}
