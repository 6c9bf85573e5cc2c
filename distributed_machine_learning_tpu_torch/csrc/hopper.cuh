// Hopper (sm_90a) building blocks shared by the tensor-core flash kernels
// in flash_fwd.cu and flash_bwd.cu: cp.async copies into 128-byte-swizzled
// shared-memory tiles, the split of f32 tiles into bf16 high and low tiles,
// wgmma shared-memory descriptors for those tiles, and warpgroup matrix
// multiplies (wgmma.mma_async) at the tile widths the kernels use.  Raw
// PTX, no library.
//
// Tile layout.  A tile of ROWS rows x DMAX bf16 columns (DMAX a multiple
// of 64) is stored as DMAX/64 column blocks of ROWS rows x 128 bytes; in
// each row the eight 16-byte chunks sit at chunk ^ (row % 8) (the 128-byte
// swizzle).  Each block is 1024-byte aligned.  The same bytes serve as a
// K-major operand (rows = M or N, columns = the contraction) and as an
// MN-major operand (rows = the contraction, columns = N), which is how V,
// dO and Q feed the second product of each kernel with no transpose.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; zero-filled when !valid.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, asynchronous; zero-filled when !valid.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Makes this thread's completed shared-memory writes visible to wgmma,
// which reads through the async proxy.  Follow with a barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Byte offset of 16-byte chunk `c` (0 .. DMAX/8 - 1) of row `r` in a
// swizzled tile of `rows` rows.
__device__ __forceinline__ uint32_t swizzled(int rows, int r, int c) {
  return (uint32_t)((c >> 3) * rows * 128 + r * 128 + (((c ^ r) & 7) << 4));
}

// Rows row0 .. row0 + ROWS - 1 of a [S, D] bf16 matrix (row stride
// `stride` elements, unit column stride, 16-byte aligned rows) into the
// swizzled tile at shared address `dst`, asynchronously; rows past S and
// columns past D (a multiple of 8) are zero.  All NT threads take part.
template <int DMAX, int ROWS, int NT>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src,
                                          long long stride, int row0, int S,
                                          int D, int tid) {
  constexpr int kChunks = DMAX / 8;  // per row
  static_assert((ROWS * kChunks) % NT == 0, "uneven tile load");
#pragma unroll
  for (int it = 0; it < ROWS * kChunks / NT; ++it) {
    const int i = tid + it * NT;
    const int r = i / kChunks;
    const int c = i % kChunks;
    const int s = row0 + r;
    const bool ok = s < S && c * 8 < D;
    const bf16* p = ok ? src + (long long)s * stride + c * 8 : src;
    cp_async16(dst + swizzled(ROWS, r, c), p, ok);
  }
}

// What load_tile (bf16) and stage_tile_f32 (f32) read with 16-byte
// copies: unit column stride, 16-byte aligned rows (element strides b, s,
// h multiples of `align`, the elements in 16 bytes, and an aligned base)
// and D a multiple of 8 (one 16-byte chunk of a bf16 tile).  `St` holds
// the strides b, s, h, d.
template <typename St>
inline bool tensor_core_operand(const void* p, const St& st, int D,
                                int align = 8) {
  return st.d == 1 && st.b % align == 0 && st.s % align == 0 &&
         st.h % align == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
         D % 8 == 0;
}

// CUDA's grid limits, which every launch of flash_fwd.cu and flash_bwd.cu
// meets by putting the (batch, head) index on gridDim.x (up to 2^31 - 1
// blocks) and the q or kv tile on gridDim.y (at most 65535, which only a
// sequence of more than 2 M rows reaches).
constexpr long long kMaxGridX = 2147483647LL;
constexpr unsigned kMaxGridY = 65535u;

// Depth of the cp.async ring of the bf16 kernels: the next tile loads
// while this one computes.  A third stage measured no faster (PERF.md).
constexpr int STAGES = 2;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// 2^x in one MUFU instruction (relative error ~2^-22; 2^-inf = 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Max and sum over the four threads that hold one accumulator row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading-dimension byte offset, stride-dimension byte offset (both in
// 16-byte units) and the layout type in bits 62-63.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// A K-major operand: 8-row groups 1024 bytes apart.  `addr` points at the
// first row, advanced by 32 bytes per 16-column step inside a block.
__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr) {
  return make_desc(addr, 16, 1024);
}

// An MN-major operand: 8-row (contraction) groups 1024 bytes apart and
// 64-column blocks `block_bytes` apart.
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t addr,
                                                  uint32_t block_bytes) {
  return make_desc(addr, block_bytes, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator registers across the
// asynchronous wgmma window.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Two floats as a bf16 pair (round to nearest even), the first in the low
// half, as the wgmma A fragment holds them.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The f32 accumulator of a 64 x N product, as wgmma lays it out: thread t
// of the warpgroup holds rows 16*(t/32) + (t%32)/4 (+8) and, for each
// 8-column chunk j, columns 8j + 2*(t%4) (+1); d[4j + e] is row
// + 8*(e/2), column + (e%2).  Its 16-column slice kk, converted to bf16
// pairs in order, is the A fragment of a product that contracts over
// those columns.
template <int N>
__device__ __forceinline__ void to_a_fragments(const float (&d)[N / 2],
                                               uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[kk][i] = pack_bf16(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1]);
}

// What the bf16 rounding of `d` into `hi` (to_a_fragments) dropped,
// rounded to bf16 in turn: d = hi + lo to about 2^-16 of d, so that
// products with hi and lo as two A operands keep d nearly at f32.
template <int N>
__device__ __forceinline__ void low_fragments(const float (&d)[N / 2],
                                              const uint32_t (&hi)[N / 16][4],
                                              uint32_t (&lo)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 h = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&hi[kk][i]));
      lo[kk][i] = pack_bf16(d[8 * kk + 2 * i] - h.x,
                            d[8 * kk + 2 * i + 1] - h.y);
    }
}

// ---- f32 operands as split bf16 parts -------------------------------------
//
// The f32 kernels hold each f32 operand x as kSplitParts bf16 tiles of the
// layout above, one after another: part 0 = bf16(x) and each next part the
// bf16 rounding of what the parts before it left, so that two parts give
// x to 2^-16 of x.  A product A B is then the sum of Ai Bj over i + j <
// kSplitParts, bf16 wgmmas into one f32 accumulator (each bf16 x bf16
// product is exact in f32): with two parts Ahi Bhi + Ahi Blo + Alo Bhi,
// the dropped Alo Blo at most 2^-16 of |A| |B|.  f32 rows reach the split
// either straight from global memory (split_tile_global, for tiles loaded
// once) or through an f32 staging tile filled by cp.async while the
// previous tile computes (stage_tile_f32, then split_tile_staged).
constexpr int kSplitParts = 2;

__device__ __forceinline__ void st_shared_v2(uint32_t addr, uint32_t a,
                                             uint32_t b) {
  asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n" ::"r"(addr), "r"(a),
               "r"(b)
               : "memory");
}

// Two floats as kSplitParts bf16 pairs (first float in the low half).
__device__ __forceinline__ void split_pair(float x, float y,
                                           uint32_t (&parts)[kSplitParts]) {
#pragma unroll
  for (int i = 0; i < kSplitParts; ++i) {
    __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    const float2 f = __bfloat1622float2(h);
    parts[i] = *reinterpret_cast<uint32_t*>(&h);
    x -= f.x;
    y -= f.y;
  }
}

// Floats col .. col + 3 (col a multiple of 4) of row r split into the
// part tiles at `tile` (each `rows` rows, part i at tile + i * part_bytes).
__device__ __forceinline__ void split_store4(uint32_t tile,
                                             uint32_t part_bytes, int rows,
                                             int r, int col, float4 x) {
  const uint32_t off = swizzled(rows, r, col / 8) + (col % 8) * 2;
  uint32_t p0[kSplitParts], p1[kSplitParts];
  split_pair(x.x, x.y, p0);
  split_pair(x.z, x.w, p1);
#pragma unroll
  for (int i = 0; i < kSplitParts; ++i)
    st_shared_v2(tile + i * part_bytes + off, p0[i], p1[i]);
}

// Rows row0 .. row0 + ROWS - 1 of a [S, D] f32 matrix (row stride
// `stride` elements, unit column stride, 16-byte aligned rows) split into
// the part tiles at `tile`, with plain loads (four 16-byte loads in
// flight a thread, which keeps the kernels' accumulators clear of
// spills); rows past S and columns past D (a multiple of 4) are zero.
// All NT threads take part.
template <int DMAX, int ROWS, int NT>
__device__ __forceinline__ void split_tile_global(uint32_t tile,
                                                  const float* src,
                                                  long long stride, int row0,
                                                  int S, int D, int tid) {
  constexpr int kChunks = DMAX / 4;  // 16-byte chunks per row
  constexpr int kPer = ROWS * kChunks / NT;
  constexpr int kBatch = kPer < 4 ? kPer : 4;
  static_assert(kPer * NT == ROWS * kChunks && kPer % kBatch == 0,
                "uneven tile split");
#pragma unroll
  for (int it0 = 0; it0 < kPer; it0 += kBatch) {
    float4 x[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = tid + (it0 + j) * NT;
      const int s = row0 + i / kChunks;
      const int c = i % kChunks;
      x[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (s < S && c * 4 < D)
        x[j] = *reinterpret_cast<const float4*>(src + (long long)s * stride +
                                                c * 4);
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = tid + (it0 + j) * NT;
      split_store4(tile, ROWS * DMAX * 2, ROWS, i / kChunks,
                   (i % kChunks) * 4, x[j]);
    }
  }
}

// The same rows as f32 into a row-major [ROWS][DMAX] staging tile at
// shared address `dst`, asynchronously (cp.async; zero past S and D).
template <int DMAX, int ROWS, int NT>
__device__ __forceinline__ void stage_tile_f32(uint32_t dst, const float* src,
                                               long long stride, int row0,
                                               int S, int D, int tid) {
  constexpr int kChunks = DMAX / 4;
  static_assert((ROWS * kChunks) % NT == 0, "uneven tile load");
#pragma unroll
  for (int it = 0; it < ROWS * kChunks / NT; ++it) {
    const int i = tid + it * NT;
    const int s = row0 + i / kChunks;
    const int c = i % kChunks;
    const bool ok = s < S && c * 4 < D;
    const float* p = ok ? src + (long long)s * stride + c * 4 : src;
    cp_async16(dst + 16u * i, p, ok);
  }
}

// A staged [ROWS][DMAX] f32 tile (stage_tile_f32, landed and visible to
// every thread) split into the part tiles at `tile`.  Each thread reads 16
// consecutive bytes and writes 8 to each part, so no access conflicts on
// a bank; four reads are in flight before the first write.
template <int DMAX, int ROWS, int NT>
__device__ __forceinline__ void split_tile_staged(uint32_t tile,
                                                  uint32_t staged, int tid) {
  constexpr int kChunks = DMAX / 4;
  constexpr int kPer = ROWS * kChunks / NT;
  constexpr int kBatch = kPer < 4 ? kPer : 4;
  static_assert(kPer * NT == ROWS * kChunks && kPer % kBatch == 0,
                "uneven tile split");
#pragma unroll
  for (int it0 = 0; it0 < kPer; it0 += kBatch) {
    float4 x[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                   : "=f"(x[j].x), "=f"(x[j].y), "=f"(x[j].z), "=f"(x[j].w)
                   : "r"(staged + 16u * (tid + (it0 + j) * NT))
                   : "memory");
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = tid + (it0 + j) * NT;
      split_store4(tile, ROWS * DMAX * 2, ROWS, i / kChunks,
                   (i % kChunks) * 4, x[j]);
    }
  }
}

// The accumulator fragment `d` of a 64 x N product (see to_a_fragments)
// as kSplitParts register A operands, part i the bf16 rounding of what
// parts 0 .. i - 1 left, one part at a time over the whole fragment (per
// entry, all parts at once, the f32 forward spilled under its
// 128-register bound).
template <int N>
__device__ __forceinline__ void split_fragments(
    const float (&d)[N / 2], uint32_t (&a)[kSplitParts][N / 16][4]) {
  float r[N / 2];
#pragma unroll
  for (int e = 0; e < N / 2; ++e) r[e] = d[e];
#pragma unroll
  for (int p = 0; p < kSplitParts; ++p)
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        __nv_bfloat162 h = __floats2bfloat162_rn(r[8 * kk + 2 * i],
                                                 r[8 * kk + 2 * i + 1]);
        a[p][kk][i] = *reinterpret_cast<uint32_t*>(&h);
        if (p + 1 < kSplitParts) {
          const float2 f = __bfloat1622float2(h);
          r[8 * kk + 2 * i] -= f.x;
          r[8 * kk + 2 * i + 1] -= f.y;
        }
      }
}

// Warpgroup products, bf16 x bf16 -> f32, m64 x N x k16.  ss: A and B
// K-major in shared memory; `accumulate` = 0 overwrites d.  rs: A from
// registers, B MN-major in shared memory, always accumulating.
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  // d[64 x 16] (+)= A[64 x 16] B[16 x 16], A and B K-major in shared memory.
  static __device__ __forceinline__ void ss(float (&d)[8], uint64_t da,
                                            uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "%8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(accumulate));
  }
};

template <>
struct Wgmma<32> {
  // d[64 x 32] (+)= A[64 x 16] B[16 x 32], A and B K-major in shared memory.
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t da,
                                            uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(accumulate));
  }
  // d[64 x 32] += A[64 x 16] B[16 x 32], A in registers (a bf16 pair per
  // register, accumulator-fragment order), B MN-major in shared memory.
  static __device__ __forceinline__ void rs(float (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  // d[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B K-major in shared memory.
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da,
                                            uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(accumulate));
  }
  // d[64 x 64] += A[64 x 16] B[16 x 64], A in registers (a bf16 pair per
  // register, accumulator-fragment order), B MN-major in shared memory.
  static __device__ __forceinline__ void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  // d[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B K-major in shared memory.
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t da,
                                            uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(accumulate));
  }
  // d[64 x 128] += A[64 x 16] B[16 x 128], A in registers (a bf16 pair per
  // register, accumulator-fragment order), B MN-major in shared memory.
  static __device__ __forceinline__ void rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

}  // namespace hopper
