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
// Bound.  At the flagship shape (B=8, S=2048, H=8, D=64, bf16) the work is
// 4*B*H*S^2*D = 68.7 GFLOP against ~68 MB of tensor traffic: the function
// is bound by operations, so the tensor cores have to do the products.
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
// f32: `flash_fwd_kernel`, CUDA-core FMAs from f32 tiles, so that f32
// results stay at f32 precision (TF32 tensor cores would not).  Tensors
// are read through their element strides and the ragged edges of S and D
// are masked, so any layout, any S and any D in 1..256 work.
//
// Measured times sit in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kColGroups = 8;   // threads sharing one q row group
constexpr int kRowGroups = 16;  // q row groups per block
constexpr int kThreads = kColGroups * kRowGroups;

struct Strides {
  long long b, s, h, d;
};

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}

// N consecutive floats from shared memory, in 16- or 8-byte loads.
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float (&out)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + i);
      out[i] = t.x;
      out[i + 1] = t.y;
      out[i + 2] = t.z;
      out[i + 3] = t.w;
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const float2 t = *reinterpret_cast<const float2*>(p + i);
      out[i] = t.x;
      out[i + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = p[i];
  }
}

__device__ __forceinline__ float group_max(float x) {
  // The 8 threads of a row group are 8 consecutive lanes of one warp.
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
  return x;
}

__device__ __forceinline__ float group_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  return x;
}

template <int DMAX, int BQ, int BK>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(DMAX * (BQ + 4) + DMAX * (BK + 4) +
                                  BK * DMAX + BK * (BQ + 4));
}

template <typename T, int DMAX, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int S, int H, int Hkv, int D,
                     Strides qs, Strides ks, Strides vs, float scale,
                     int causal) {
  constexpr int R = BQ / kRowGroups;    // q rows per thread
  constexpr int CS = BK / kColGroups;   // score columns per thread
  constexpr int CO = DMAX / kColGroups; // output columns per thread
  constexpr int QP = BQ + 4;            // padded row of the q^T / p^T tiles
  constexpr int KP = BK + 4;            // padded row of the k^T tile
  static_assert(R >= 1 && CS >= 1 && CO >= 1, "tile too small");

  extern __shared__ float4 smem4[];
  float* sQT = reinterpret_cast<float*>(smem4);  // [DMAX][QP]
  float* sKT = sQT + DMAX * QP;                  // [DMAX][KP]
  float* sV = sKT + DMAX * KP;                   // [BK][DMAX]
  float* sPT = sV + BK * DMAX;                   // [BK][QP]

  const int tid = threadIdx.x;
  const int rg = tid / kColGroups;
  const int cg = tid % kColGroups;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / (H / Hkv);  // _kv_row_map: kv row b*Hkv + h // group
  const int q0 = blockIdx.y * BQ;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  // The q tile, transposed and zero-padded past S and D.
  for (int idx = tid; idx < BQ * DMAX; idx += kThreads) {
    const int r = idx / DMAX;
    const int d = idx % DMAX;
    const int s = q0 + r;
    float val = 0.f;
    if (s < S && d < D) val = to_f32(qb[s * qs.s + d * qs.d]);
    sQT[d * QP + r] = val;
  }

  float m[R], l[R], acc[R][CO];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CO; ++j) acc[i][j] = 0.f;
  }

  int n_kv = (S + BK - 1) / BK;
  if (causal) {
    // A kv tile is live iff it meets the causal triangle of this q tile.
    n_kv = min(n_kv, (q0 + BQ - 1) / BK + 1);
  }

  for (int t = 0; t < n_kv; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < BK * DMAX; idx += kThreads) {
      const int c = idx / DMAX;
      const int d = idx % DMAX;
      const int s = k0 + c;
      float kv = 0.f, vv = 0.f;
      if (s < S && d < D) {
        kv = to_f32(kb[s * ks.s + d * ks.d]);
        vv = to_f32(vb[s * vs.s + d * vs.d]);
      }
      sKT[d * KP + c] = kv;
      sV[c * DMAX + d] = vv;
    }
    __syncthreads();

    // Scores for rows rg*R + i and columns cg*CS + j of this tile.
    float sc[R][CS];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < CS; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DMAX; ++d) {
      float qr[R], kc[CS];
      load_vec<R>(sQT + d * QP + rg * R, qr);
      load_vec<CS>(sKT + d * KP + cg * CS, kc);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < CS; ++j) sc[i][j] = fmaf(qr[i], kc[j], sc[i][j]);
    }

    // Online softmax, one row at a time, reduced over the row group.
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = q0 + rg * R + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CS; ++j) {
        const int col = k0 + cg * CS + j;
        float x = sc[i][j] * scale;
        if (col >= S || (causal && col > row)) x = -INFINITY;
        sc[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = group_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float m_safe = isfinite(m_new) ? m_new : 0.f;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CS; ++j) {
        const float x = sc[i][j];
        const float p = isfinite(x) ? expf(x - m_safe) : 0.f;
        sc[i][j] = p;
        rs += p;
      }
      rs = group_sum(rs);
      const float corr = isfinite(m[i]) ? expf(m[i] - m_safe) : 0.f;
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < CO; ++j) acc[i][j] *= corr;
    }

#pragma unroll
    for (int j = 0; j < CS; ++j)
#pragma unroll
      for (int i = 0; i < R; ++i) sPT[(cg * CS + j) * QP + rg * R + i] = sc[i][j];
    __syncthreads();

    // acc += P . V for rows rg*R + i and head-dim columns cg*CO + j.
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pr[R], vr[CO];
      load_vec<R>(sPT + c * QP + rg * R, pr);
      load_vec<CO>(sV + c * DMAX + cg * CO, vr);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < CO; ++j) acc[i][j] = fmaf(pr[i], vr[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + rg * R + i;
    if (row >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = o + (((long long)b * S + row) * H + h) * (long long)D;
#pragma unroll
    for (int j = 0; j < CO; ++j) {
      const int d = cg * CO + j;
      if (d < D) orow[d] = from_f32<T>(acc[i][j] / denom);
    }
    if (cg == 0) {
      lse[(long long)bh * S + row] =
          isfinite(m[i]) ? m[i] + logf(denom) : -INFINITY;
    }
  }
}

template <typename T, int DMAX, int BQ, int BK>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int S, int H, int Hkv, int D,
                   Strides qs, Strides ks, Strides vs, float scale,
                   int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DMAX, BQ, BK>();
  auto kern = flash_fwd_kernel<T, DMAX, BQ, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (S + BQ - 1) / BQ);
  if (grid.y > hopper::kMaxGridY) return cudaErrorInvalidValue;
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, S, H, Hkv, D, qs,
      ks, vs, scale, causal);
  return cudaGetLastError();
}

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

// ---- f32 dispatch ---------------------------------------------------------

// f32 tiles per head-dim bucket; ops/flash_attention.py::KERNEL_TILES
// ["float32"] mirrors this table.  Untuned: the first correct choice that
// fits shared memory (the largest, D <= 256, takes 181 KB).
template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     float* lse, int B, int S, int H, int Hkv, int D,
                     Strides qs, Strides ks, Strides vs, float scale,
                     int causal, cudaStream_t stream) {
  if (D <= 32)
    return launch<T, 32, 64, 64>(q, k, v, o, lse, B, S, H, Hkv, D, qs, ks,
                                 vs, scale, causal, stream);
  if (D <= 64)
    return launch<T, 64, 64, 64>(q, k, v, o, lse, B, S, H, Hkv, D, qs, ks,
                                 vs, scale, causal, stream);
  if (D <= 128)
    return launch<T, 128, 64, 64>(q, k, v, o, lse, B, S, H, Hkv, D, qs, ks,
                                  vs, scale, causal, stream);
  return launch<T, 256, 32, 64>(q, k, v, o, lse, B, S, H, Hkv, D, qs, ks,
                                vs, scale, causal, stream);
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 when the launch was accepted.  Strides are in
// elements; o is a contiguous [B, S, H, D] tensor of the input dtype and
// lse a contiguous [B*H, S] f32 tensor.  bf16 inputs must satisfy
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
  if (is_bf16) {
    if (!hopper::tensor_core_operand(q, qs, D) ||
        !hopper::tensor_core_operand(k, ks, D) ||
        !hopper::tensor_core_operand(v, vs, D))
      return (int)cudaErrorInvalidValue;
    return (int)dispatch_wgmma(q, k, v, o, lse, B, S, H, Hkv, D, qs, ks, vs,
                               scale, causal, st);
  }
  return (int)dispatch<float>(q, k, v, o, lse, B, S, H, Hkv, D, qs, ks, vs,
                              scale, causal, st);
}

const char* dml_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
