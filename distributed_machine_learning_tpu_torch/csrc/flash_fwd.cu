// Flash-attention forward for Hopper (sm_90a), written by hand.
//
// Replaces the TPU kernel `_flash_kernel` launched by `_flash_forward` in
// distributed_machine_learning_tpu/ops/pallas_attention.py.  Same function:
// softmax attention with an online softmax (running max, denominator and
// output accumulator in f32), causal kv-tile skipping, grouped-query kv
// read at Hkv heads through the `_kv_row_map` row rule, O in the input
// dtype and a per-row logsumexp in f32.  Fully masked rows give O = 0 and
// lse = -inf, as on the TPU.
//
// Bound.  At the flagship shape (B=8, S=2048, H=8, D=64) the work is
// 4*B*H*S^2*D = 68.7 GFLOP against ~68 MB (bf16) or ~136 MB (f32) of
// tensor traffic: the function is bound by operations, so the tensor
// cores have to do the products, in f32 as split bf16 at a third of the
// bf16 rate.
//
// bf16: `flash_fwd_kernel_wgmma`.  One block per (batch*head, q tile of
// 64 rows per warpgroup); a loop over kv tiles takes the place of the TPU
// grid's sequential kv axis.  Q and a two-stage ring of K/V tiles sit in
// shared memory as bf16 in the swizzled layout of hopper.cuh, filled by
// cp.async (zero past S and D) so that tile t+1 loads while tile t
// computes.  S = Q K^T is a wgmma from shared memory (both operands
// K-major in the head dim).  The online softmax runs on the f32
// accumulator fragment in registers: row max and sum across the four
// threads of a row with shuffles, scale*log2(e) folded into one ex2
// instruction, the mask applied only on the ragged and diagonal tiles.
// P is split in registers into a bf16 high part and the bf16 rounding of
// the rest, and O += P V is two register-A wgmmas with V read MN-major
// from the same tile, so P enters the product to about 2^-16 (P rounded
// to bf16 alone moved a whole training step past its limit, PERF.md; the
// second product costs a quarter of the kernel's time).  The wrapper
// hands in unit-stride, 16-byte-aligned rows with D a multiple of 8
// (ops/flash_attention.py pads and copies what does not conform).
//
// f32: `flash_fwd_kernel_wgmma_f32`, the same design on the tensor cores
// with every operand split into bf16 high and low tiles (hopper.cuh,
// kSplitParts = 2): S = Q K^T is Qhi Khi + Qhi Klo + Qlo Khi and O += P V
// is Phi Vhi + Phi Vlo + Plo Vhi, three bf16 wgmmas each, so every
// operand enters its product to about 2^-16 and the result stays within
// the f32 tolerance (a single tf32 or bf16 product would not).  f32 rows
// cannot be split on the way through cp.async, so Q is split once from
// global memory, and each K/V tile lands by cp.async in an f32 staging
// tile while the previous tile computes, then one pass splits it into
// the hi/lo tiles (97 KB of shared memory at D <= 64, so two blocks share
// an SM and one block's split pass overlaps the other's products).  The
// wrapper hands in unit-stride, 16-byte-aligned rows with D a multiple of
// 8, as for bf16.
//
// Measured times sit in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

struct Strides {
  long long b, s, h, d;
};

// ---- bf16 on the tensor cores -------------------------------------------

template <int DMAX, int BK, int NWG>
constexpr size_t wgmma_smem_bytes() {
  // Q [BQ x DMAX] and STAGES stages of K and V [BK x DMAX], bf16, plus the
  // slack that aligns the base to 1024 bytes.
  return (size_t)2 * DMAX * (64 * NWG + 2 * hopper::STAGES * BK) + 1024;
}

// Scores of one kv tile (this thread's fragment, see to_a_fragments) to
// the log2 domain, with the causal and ragged-edge mask where MASK, and
// their row maxima over this thread's columns.
template <bool MASK, int BK>
__device__ __forceinline__ void scale_scores(float (&s)[BK / 2], float sl2,
                                             int k0, int col0, int row0,
                                             int S, int causal,
                                             float (&mx)[2]) {
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * j + e] * sl2;
      if (MASK) {
        const int col = k0 + 8 * j + col0 + (e & 1);
        if (col >= S || (causal && col > row0 + 8 * (e >> 1))) x = -INFINITY;
      }
      s[4 * j + e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
}

template <int DMAX, int BK, int NWG>
__global__ void __launch_bounds__(128 * NWG, DMAX == 64 ? 2 : 1)
    flash_fwd_kernel_wgmma(const hopper::bf16* __restrict__ q,
                           const hopper::bf16* __restrict__ k,
                           const hopper::bf16* __restrict__ v,
                           hopper::bf16* __restrict__ o,
                           float* __restrict__ lse, int S, int H, int Hkv,
                           int D, Strides qs, Strides ks, Strides vs,
                           float scale, int causal) {
  using namespace hopper;
  constexpr int BQ = 64 * NWG;
  constexpr int NT = 128 * NWG;
  constexpr int NCH = DMAX < 128 ? DMAX : 128;  // O columns per P.V wgmma
  constexpr uint32_t kQBytes = BQ * DMAX * 2;
  constexpr uint32_t kKVBytes = BK * DMAX * 2;
  static_assert(DMAX % 64 == 0 && BK % 16 == 0, "tiles");

  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  auto sK = [&](int st) { return sQ + kQBytes + st * 2 * kKVBytes; };
  auto sV = [&](int st) { return sK(st) + kKVBytes; };

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int g = (tid % 32) / 4;  // row within the warp's 8-row half
  const int c4 = tid % 4;        // column pair within an 8-column chunk
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / (H / Hkv);  // _kv_row_map: kv row b*Hkv + h // group
  const int q0 = blockIdx.y * BQ;
  const int row0 = q0 + 64 * wg + 16 * warp + g;  // and row0 + 8

  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + hk * ks.h;
  const bf16* vb = v + b * vs.b + hk * vs.h;
  auto load_kv = [&](int t) {
    const int st = t % STAGES;
    load_tile<DMAX, BK, NT>(sK(st), kb, ks.s, t * BK, S, D, tid);
    load_tile<DMAX, BK, NT>(sV(st), vb, vs.s, t * BK, S, D, tid);
  };

  int n_kv = (S + BK - 1) / BK;
  if (causal) {
    // A kv tile is live iff it meets the causal triangle of this q tile.
    n_kv = min(n_kv, (q0 + BQ - 1) / BK + 1);
  }

  // The ring: Q with kv tile 0, then one commit group per kv tile.
  load_tile<DMAX, BQ, NT>(sQ, qb, qs.s, q0, S, D, tid);
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < n_kv) load_kv(t);
    cp_async_commit();
  }

  float acc[DMAX / 2];
#pragma unroll
  for (int i = 0; i < DMAX / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max, log2 domain
  float l[2] = {0.f, 0.f};              // this thread's share of the sum
  const float sl2 = scale * kLog2e;

  for (int t = 0; t < n_kv; ++t) {
    const int st = t % STAGES;
    if (t + STAGES - 1 < n_kv) load_kv(t + STAGES - 1);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();  // tile t (and Q) have landed
    fence_proxy_async();
    __syncthreads();

    // S = Q K^T for this warpgroup's 64 rows.
    float s[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DMAX / 16; ++kk) {
      const uint32_t col = (kk % 4) * 32;  // within the 128-byte row
      Wgmma<BK>::ss(s,
                    desc_k_major(sQ + (kk / 4) * BQ * 128 + wg * 64 * 128 + col),
                    desc_k_major(sK(st) + (kk / 4) * BK * 128 + col), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // Online softmax on the fragment: rows row0 + 8*(e/2), columns
    // k0 + 8j + 2*c4 + e%2.  Only the ragged last tile and tiles that
    // cross this warpgroup's causal diagonal need the mask.
    const int k0 = t * BK;
    float mx[2] = {-INFINITY, -INFINITY};
    if (k0 + BK > S || (causal && k0 + BK - 1 > q0 + 64 * wg))
      scale_scores<true, BK>(s, sl2, k0, 2 * c4, row0, S, causal, mx);
    else
      scale_scores<false, BK>(s, sl2, k0, 2 * c4, row0, S, causal, mx);
    float m_safe[2], corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      m_safe[r] = m_new == -INFINITY ? 0.f : m_new;
      corr[r] = fast_exp2(m[r] - m_safe[r]);
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = fast_exp2(s[4 * j + e] - m_safe[e >> 1]);
        s[4 * j + e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int j = 0; j < DMAX / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[4 * j + e] *= corr[e >> 1];

    // O += P V with P split into a bf16 high and low part, two A operands.
    uint32_t a_hi[BK / 16][4], a_lo[BK / 16][4];
    to_a_fragments<BK>(s, a_hi);
    low_fragments<BK>(s, a_hi, a_lo);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int nc = 0; nc < DMAX / NCH; ++nc) {
        float(&o)[NCH / 2] =
            *reinterpret_cast<float(*)[NCH / 2]>(&acc[nc * NCH / 2]);
        const uint64_t dv = desc_mn_major(
            sV(st) + kk * 2048 + nc * (NCH / 64) * BK * 128, BK * 128);
        Wgmma<NCH>::rs(o, a_hi[kk], dv);
        Wgmma<NCH>::rs(o, a_lo[kk], dv);
      }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncthreads();  // every warpgroup is done with stage st
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const float denom = fmaxf(quad_sum(l[r]), 1e-30f);
    if (row >= S) continue;
    bf16* orow = o + (((long long)b * S + row) * H + h) * (long long)D;
#pragma unroll
    for (int j = 0; j < DMAX / 8; ++j) {
      const int d = 8 * j + 2 * c4;
      if (d < D)
        *reinterpret_cast<__nv_bfloat162*>(orow + d) = __floats2bfloat162_rn(
            acc[4 * j + 2 * r] / denom, acc[4 * j + 2 * r + 1] / denom);
    }
    if (c4 == 0)
      lse[(long long)bh * S + row] =
          m[r] == -INFINITY ? -INFINITY : (m[r] + log2f(denom)) * kLn2;
  }
}

template <int DMAX, int BK, int NWG>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* o, float* lse, int B, int S, int H, int Hkv,
                         int D, Strides qs, Strides ks, Strides vs,
                         float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = wgmma_smem_bytes<DMAX, BK, NWG>();
  auto kern = flash_fwd_kernel_wgmma<DMAX, BK, NWG>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (S + 64 * NWG - 1) / (64 * NWG));
  if (grid.y > hopper::kMaxGridY) return cudaErrorInvalidValue;
  kern<<<grid, 128 * NWG, smem, stream>>>(
      static_cast<const hopper::bf16*>(q), static_cast<const hopper::bf16*>(k),
      static_cast<const hopper::bf16*>(v), static_cast<hopper::bf16*>(o), lse,
      S, H, Hkv, D, qs, ks, vs, scale, causal);
  return cudaGetLastError();
}

// bf16 tiles per head-dim bucket, (block_q, block_k) = (64 * NWG, BK);
// ops/flash_attention.py::KERNEL_TILES["bfloat16"] mirrors this table.
// Shared memory: 49, 97 and 97 KB.  At D <= 64 the 64-column kv tile and
// the launch bound keep a thread at 128 registers, so two blocks share an
// SM and one block's softmax overlaps the other's products (PERF.md has
// the tiles measured).  At D = 256 the 32-column tile keeps O (128
// registers a thread) and S within 255.
cudaError_t dispatch_wgmma(const void* q, const void* k, const void* v,
                           void* o, float* lse, int B, int S, int H, int Hkv,
                           int D, Strides qs, Strides ks, Strides vs,
                           float scale, int causal, cudaStream_t stream) {
  if (D <= 64)
    return launch_wgmma<64, 64, 2>(q, k, v, o, lse, B, S, H, Hkv, D, qs, ks,
                                   vs, scale, causal, stream);
  if (D <= 128)
    return launch_wgmma<128, 64, 2>(q, k, v, o, lse, B, S, H, Hkv, D, qs, ks,
                                    vs, scale, causal, stream);
  return launch_wgmma<256, 32, 1>(q, k, v, o, lse, B, S, H, Hkv, D, qs, ks,
                                  vs, scale, causal, stream);
}

// ---- f32 on the tensor cores, as split bf16 -------------------------------

template <int DMAX, int BK, int NWG>
constexpr size_t f32_smem_bytes() {
  // Q [BQ x DMAX] and K, V [BK x DMAX] as kSplitParts bf16 tiles each,
  // the f32 staging tiles of K and V, and the slack that aligns the base.
  return (size_t)2 * hopper::kSplitParts * DMAX * (64 * NWG + 2 * BK) +
         (size_t)8 * BK * DMAX + 1024;
}

template <int DMAX, int BK, int NWG>
__global__ void __launch_bounds__(128 * NWG, DMAX == 64 ? 2 : 1)
    flash_fwd_kernel_wgmma_f32(const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v,
                               float* __restrict__ o,
                               float* __restrict__ lse, int S, int H,
                               int Hkv, int D, Strides qs, Strides ks,
                               Strides vs, float scale, int causal) {
  using namespace hopper;
  constexpr int BQ = 64 * NWG;
  constexpr int NT = 128 * NWG;
  constexpr int NCH = DMAX < 128 ? DMAX : 128;  // O columns per P.V wgmma
  constexpr int P = kSplitParts;
  constexpr uint32_t kQBytes = BQ * DMAX * 2;   // one bf16 part
  constexpr uint32_t kKVBytes = BK * DMAX * 2;
  constexpr uint32_t kStageBytes = BK * DMAX * 4;
  static_assert(DMAX % 64 == 0 && BK % 16 == 0, "tiles");

  // The parts of Q, K and V (part i of Q at sQ + i * kQBytes, ...), then
  // the f32 staging tiles of K and V.
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = sQ + P * kQBytes;
  const uint32_t sV = sK + P * kKVBytes;
  const uint32_t sKf = sV + P * kKVBytes;
  const uint32_t sVf = sKf + kStageBytes;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int g = (tid % 32) / 4;  // row within the warp's 8-row half
  const int c4 = tid % 4;        // column pair within an 8-column chunk
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / (H / Hkv);  // _kv_row_map: kv row b*Hkv + h // group
  const int q0 = blockIdx.y * BQ;
  const int row0 = q0 + 64 * wg + 16 * warp + g;  // and row0 + 8

  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + hk * ks.h;
  const float* vb = v + b * vs.b + hk * vs.h;
  auto stage_kv = [&](int t) {
    stage_tile_f32<DMAX, BK, NT>(sKf, kb, ks.s, t * BK, S, D, tid);
    stage_tile_f32<DMAX, BK, NT>(sVf, vb, vs.s, t * BK, S, D, tid);
    cp_async_commit();
  };

  int n_kv = (S + BK - 1) / BK;
  if (causal) {
    // A kv tile is live iff it meets the causal triangle of this q tile.
    n_kv = min(n_kv, (q0 + BQ - 1) / BK + 1);
  }

  // kv tile 0 lands while Q is split.
  stage_kv(0);
  split_tile_global<DMAX, BQ, NT>(sQ, qb, qs.s, q0, S, D, tid);

  float acc[DMAX / 2];
#pragma unroll
  for (int i = 0; i < DMAX / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max, log2 domain
  float l[2] = {0.f, 0.f};              // this thread's share of the sum
  const float sl2 = scale * kLog2e;

  for (int t = 0; t < n_kv; ++t) {
    cp_async_wait<0>();
    __syncthreads();  // tile t is staged; every warpgroup is done with t - 1
    split_tile_staged<DMAX, BK, NT>(sK, sKf, tid);
    split_tile_staged<DMAX, BK, NT>(sV, sVf, tid);
    fence_proxy_async();
    __syncthreads();  // the part tiles are visible to wgmma; staging is free
    if (t + 1 < n_kv) stage_kv(t + 1);

    // S = Q K^T for this warpgroup's 64 rows: Qi Kj over i + j < P.
    float s[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DMAX / 16; ++kk) {
      const uint32_t col = (kk % 4) * 32;  // within the 128-byte row
      const uint32_t q_off = (kk / 4) * BQ * 128 + wg * 64 * 128 + col;
      const uint32_t k_off = (kk / 4) * BK * 128 + col;
#pragma unroll
      for (int i = 0; i < P; ++i)
#pragma unroll
        for (int j = 0; i + j < P; ++j)
          Wgmma<BK>::ss(s, desc_k_major(sQ + i * kQBytes + q_off),
                        desc_k_major(sK + j * kKVBytes + k_off),
                        kk + i + j > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // Online softmax on the fragment, as in the bf16 kernel.
    const int k0 = t * BK;
    float mx[2] = {-INFINITY, -INFINITY};
    if (k0 + BK > S || (causal && k0 + BK - 1 > q0 + 64 * wg))
      scale_scores<true, BK>(s, sl2, k0, 2 * c4, row0, S, causal, mx);
    else
      scale_scores<false, BK>(s, sl2, k0, 2 * c4, row0, S, causal, mx);
    float m_safe[2], corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      m_safe[r] = m_new == -INFINITY ? 0.f : m_new;
      corr[r] = fast_exp2(m[r] - m_safe[r]);
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = fast_exp2(s[4 * j + e] - m_safe[e >> 1]);
        s[4 * j + e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int j = 0; j < DMAX / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[4 * j + e] *= corr[e >> 1];

    // O += P V: Pi Vj over i + j < P, P's parts as register A operands.
    uint32_t a[P][BK / 16][4];
    split_fragments<BK>(s, a);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int nc = 0; nc < DMAX / NCH; ++nc) {
        float(&o)[NCH / 2] =
            *reinterpret_cast<float(*)[NCH / 2]>(&acc[nc * NCH / 2]);
        const uint32_t off = kk * 2048 + nc * (NCH / 64) * BK * 128;
#pragma unroll
        for (int i = 0; i < P; ++i)
#pragma unroll
          for (int j = 0; i + j < P; ++j)
            Wgmma<NCH>::rs(o, a[i][kk],
                           desc_mn_major(sV + j * kKVBytes + off, BK * 128));
      }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const float denom = fmaxf(quad_sum(l[r]), 1e-30f);
    if (row >= S) continue;
    float* orow = o + (((long long)b * S + row) * H + h) * (long long)D;
#pragma unroll
    for (int j = 0; j < DMAX / 8; ++j) {
      const int d = 8 * j + 2 * c4;
      if (d < D)
        *reinterpret_cast<float2*>(orow + d) = make_float2(
            acc[4 * j + 2 * r] / denom, acc[4 * j + 2 * r + 1] / denom);
    }
    if (c4 == 0)
      lse[(long long)bh * S + row] =
          m[r] == -INFINITY ? -INFINITY : (m[r] + log2f(denom)) * kLn2;
  }
}

template <int DMAX, int BK, int NWG>
cudaError_t launch_wgmma_f32(const void* q, const void* k, const void* v,
                             void* o, float* lse, int B, int S, int H,
                             int Hkv, int D, Strides qs, Strides ks,
                             Strides vs, float scale, int causal,
                             cudaStream_t stream) {
  constexpr size_t smem = f32_smem_bytes<DMAX, BK, NWG>();
  auto kern = flash_fwd_kernel_wgmma_f32<DMAX, BK, NWG>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (S + 64 * NWG - 1) / (64 * NWG));
  if (grid.y > hopper::kMaxGridY) return cudaErrorInvalidValue;
  kern<<<grid, 128 * NWG, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, S, H, Hkv,
      D, qs, ks, vs, scale, causal);
  return cudaGetLastError();
}

// f32 tiles per head-dim bucket, the bf16 table's; ops/flash_attention.py
// ::KERNEL_TILES["float32"] mirrors it.  Shared memory: 97, 193 and 193
// KB (two blocks per SM at D <= 64).
cudaError_t dispatch_wgmma_f32(const void* q, const void* k, const void* v,
                               void* o, float* lse, int B, int S, int H,
                               int Hkv, int D, Strides qs, Strides ks,
                               Strides vs, float scale, int causal,
                               cudaStream_t stream) {
  if (D <= 64)
    return launch_wgmma_f32<64, 64, 2>(q, k, v, o, lse, B, S, H, Hkv, D, qs,
                                       ks, vs, scale, causal, stream);
  if (D <= 128)
    return launch_wgmma_f32<128, 64, 2>(q, k, v, o, lse, B, S, H, Hkv, D, qs,
                                        ks, vs, scale, causal, stream);
  return launch_wgmma_f32<256, 32, 1>(q, k, v, o, lse, B, S, H, Hkv, D, qs,
                                      ks, vs, scale, causal, stream);
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 when the launch was accepted.  Strides are in
// elements; o is a contiguous [B, S, H, D] tensor of the input dtype and
// lse a contiguous [B*H, S] f32 tensor.  Inputs must satisfy
// tensor_core_operand (cudaErrorInvalidValue otherwise).
int dml_flash_fwd(const void* q, const void* k, const void* v, void* o,
                  float* lse, int B, int S, int H, int Hkv, int D,
                  long long qsb, long long qss, long long qsh, long long qsd,
                  long long ksb, long long kss, long long ksh, long long ksd,
                  long long vsb, long long vss, long long vsh, long long vsd,
                  float scale, int causal, int is_bf16, void* stream) {
  if (B < 1 || S < 1 || H < 1 || Hkv < 1 || H % Hkv != 0 || D < 1 ||
      D > 256 || (long long)B * H > hopper::kMaxGridX)
    return (int)cudaErrorInvalidValue;
  const Strides qs{qsb, qss, qsh, qsd};
  const Strides ks{ksb, kss, ksh, ksd};
  const Strides vs{vsb, vss, vsh, vsd};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int align = is_bf16 ? 8 : 4;  // elements in 16 bytes
  if (!hopper::tensor_core_operand(q, qs, D, align) ||
      !hopper::tensor_core_operand(k, ks, D, align) ||
      !hopper::tensor_core_operand(v, vs, D, align))
    return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return (int)dispatch_wgmma(q, k, v, o, lse, B, S, H, Hkv, D, qs, ks, vs,
                               scale, causal, st);
  return (int)dispatch_wgmma_f32(q, k, v, o, lse, B, S, H, Hkv, D, qs, ks,
                                 vs, scale, causal, st);
}

const char* dml_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
