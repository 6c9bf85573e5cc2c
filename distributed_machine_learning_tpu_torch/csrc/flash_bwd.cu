// Flash-attention backward for Hopper (sm_90a), written by hand: the dK/dV
// kernel and the dQ kernel.
//
// Replaces the TPU kernels `_bwd_dkdv_kernel` and `_bwd_dq_kernel` (with
// their shared block math `_bwd_recompute`), launched by `_flash_backward`
// in distributed_machine_learning_tpu/ops/pallas_attention.py.  Same
// function: P = exp(Q K^T * scale - lse) recomputed per tile from the
// forward's logsumexp (masked logits and rows with lse = -inf give P = 0),
// dS = P * (dO V^T - delta) * scale with delta = rowsum(dO * O), then
//   dV = sum P^T dO and dK = sum dS^T Q   (kernel dkdv),
//   dQ = sum dS K                          (kernel dq),
// all accumulated in f32 and written once in the input dtype.  Nothing of
// size S x S reaches device memory.
//
// Ownership.  The TPU grid carries its accumulators in VMEM scratch across
// a sequential grid axis.  Here each thread block owns one output tile and
// loops over the other axis itself, with its accumulator in f32 registers
// for the whole loop:
//   * dkdv: one block per (b*Hkv + kv_head, kv tile).  It loops over the
//     group's q heads x q tiles (grouped-query attention: the H/Hkv q heads
//     that read this kv head), so the group's reduction happens inside the
//     block -- no atomics, the same result on every run, and dK/dV never
//     exist at full H.
//   * dq: one block per (b*H + head, q tile), looping over kv tiles; k and
//     v are read at Hkv heads through the `_kv_row_map` rule.
// The causal liveness rule is the TPU kernels': a (q tile, kv tile) pair
// is computed iff k_start <= q_start + block_q - 1.
//
// Bound.  At the flagship training shape (B=8, S=2048, H=8, D=64,
// non-causal) dkdv does 8*B*H*S^2*D = 137 GFLOP and dq 6*B*H*S^2*D =
// 103 GFLOP against ~0.1 GB (bf16) or ~0.2 GB (f32) of tensor traffic:
// both are bound by operations.
//
// bf16 dkdv: `flash_bwd_dkdv_kernel_wgmma`, on the tensor cores.  Two
// warpgroups; each owns 64 kv rows (or, at D > 64, the same 64 rows and
// half of the head dim of dK/dV, so that both accumulators fit in
// registers).  K and V stay in shared memory as bf16 (the swizzled layout
// of hopper.cuh); Q, dO, lse and delta of each q tile stream through a
// two-stage cp.async ring, so tile i+1 loads while tile i computes.
// S^T = K Q^T and dP^T = V dO^T are wgmmas from shared memory (all four
// operands K-major in the head dim).  P^T = exp2(S^T scale log2(e) -
// lse log2(e)) and dS^T = P^T (dP^T - delta) scale are formed in f32 on
// the accumulator fragments, one ex2 instruction per entry, the mask
// applied only on the ragged and diagonal tiles.  Both are rounded to
// bf16 in registers, and dV += P^T dO, dK += dS^T Q are register-A wgmmas
// with dO and Q read MN-major from the same tiles.  The rounding of P^T
// and dS^T to bf16 is the one rounding point the f32 reference does not
// have (it moves a whole training step 50x less than the forward's
// rounding of P did, PERF.md).  The wrapper hands in unit-stride,
// 16-byte-aligned rows with D a multiple of 8 (ops/flash_attention.py
// pads and copies what does not conform).
//
// bf16 dq: `flash_bwd_dq_kernel_wgmma`, the forward's design with V
// replaced by K in the last product.  One block per (b*H + head, 128 q
// rows), two warpgroups of 64 rows (64 rows and one warpgroup at D > 128;
// at D <= 64 two blocks share an SM).
// Q and dO stay in shared memory as bf16 tiles, the block's lse and delta
// in registers (two rows a thread); K and V stream through the two-stage
// cp.async ring, stopping at the last live kv tile under causal.  S = Q K^T
// and dP = dO V^T are wgmmas from shared memory (K and V read K-major);
// P and dS = P (dP - delta) scale are formed in f32 on the accumulator
// fragments with one ex2 instruction per entry, the mask applied only on
// the ragged and diagonal kv tiles.  dS is rounded to bf16 as the register
// A operand of dQ += dS K, with K read MN-major from the same tile, so
// nothing is transposed; dQ accumulates in f32 registers and is written
// once.  No atomics: a rerun gives the same bits.
//
// f32 dkdv: `flash_bwd_dkdv_kernel_wgmma_f32`, the bf16 dkdv design on
// the tensor cores with every operand split into bf16 high and low tiles
// (hopper.cuh, kSplitParts = 2): each of S^T = K Q^T, dP^T = V dO^T,
// dV += P^T dO and dK += dS^T Q is three bf16 wgmmas (hi hi + hi lo + lo
// hi), P^T and dS^T split in registers, so every operand enters to about
// 2^-16 and the result stays within the f32 tolerance (a single tf32 or
// bf16 product would not).  K and V are split once from global memory;
// each step's Q and dO land by cp.async in f32 staging tiles while the
// previous step computes, and one pass splits them.  The q tile is 32
// rows at D = 128 and 16 at D = 256 (registers, shared memory).  No
// atomics.  The wrapper hands in conforming rows, as for bf16.
//
// f32 dq: `flash_bwd_dq_kernel_wgmma_f32`, the bf16 dq design with every
// operand split as in f32 dkdv.  S = Q K^T, dP = dO V^T and dQ += dS K are
// each three bf16 wgmmas of the parts.  Q and dO are split once from
// global memory and stay resident; each kv tile's K and V land by cp.async
// in f32 staging tiles while the previous tile computes, and one pass
// splits them.  dS is split in registers into two A operands: rounded to
// bf16 once, as bf16 dq does, it would leave dQ outside the f32 tolerance.
// Bound: the split does three bf16 products per product, so the flagship's
// 103 GFLOP take at least 0.31 ms at a third of the bf16 peak (against
// 1.54 ms at the f32 CUDA-core peak).  Tiles: 32 kv columns (16 at
// D = 256, one warpgroup), so that the part and staging tiles fit shared
// memory and two blocks share an SM at D <= 64.  No atomics.  The wrapper
// hands in conforming rows, as for every kernel here.
//
// Grid.  Every launch puts the (b, head) index on gridDim.x and the tile
// on gridDim.y (hopper.cuh: kMaxGridX, kMaxGridY), so B*H is not capped
// at 65535 as the y axis would cap it.
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

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  int B, S, H, Hkv, D;
  Strides qs, ks, vs, dos;
  float scale;
  int causal;
};

// ---- bf16 dK/dV on the tensor cores --------------------------------------

template <int DMAX, int BQ, int DSPLIT>
constexpr size_t dkdv_wgmma_smem_bytes() {
  // K and V [BKV x DMAX]; STAGES stages of Q and dO [BQ x DMAX], bf16, and
  // of lse and delta [BQ] f32; plus the slack that aligns the base.
  using hopper::STAGES;
  return (size_t)2 * DMAX * (2 * (128 / DSPLIT) + 2 * STAGES * BQ) +
         8 * STAGES * BQ + 1024;
}

// P^T and dS^T of one (kv tile, q tile) pair on this thread's fragments
// (kv rows kvrow0 + 8*(e/2), q columns qt0 + 8j + 2*c4 + e%2), in place of
// S^T and dP^T.  MASK applies the ragged-edge and causal rules; a row with
// lse = -inf gives 0 either way.
template <bool MASK, int BQ>
__device__ __forceinline__ void recompute_wgmma(
    float (&sT)[BQ / 2], float (&dpT)[BQ / 2], const float* s_lse,
    const float* s_delta, int qt0, int col0, int kvrow0, int S, int causal,
    float sl2, float scale) {
#pragma unroll
  for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qc = 8 * j + col0 + (e & 1);
      const float l = s_lse[qc];
      bool live = isfinite(l);
      if (MASK) {
        const int qrow = qt0 + qc;
        live = live && qrow < S && !(causal && kvrow0 + 8 * (e >> 1) > qrow);
      }
      const float p =
          live ? hopper::fast_exp2(sT[4 * j + e] * sl2 - l * hopper::kLog2e)
               : 0.f;
      sT[4 * j + e] = p;
      dpT[4 * j + e] = p * (dpT[4 * j + e] - s_delta[qc]) * scale;
    }
}

template <int DMAX, int BQ, int DSPLIT>
__global__ void __launch_bounds__(256, 1) flash_bwd_dkdv_kernel_wgmma(
    const hopper::bf16* __restrict__ q, const hopper::bf16* __restrict__ k,
    const hopper::bf16* __restrict__ v, const hopper::bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    hopper::bf16* __restrict__ dk, hopper::bf16* __restrict__ dv, int S,
    int H, int Hkv, int D, Strides qs, Strides ks, Strides vs, Strides dos,
    float scale, int causal) {
  using namespace hopper;
  constexpr int NT = 256;
  constexpr int BKV = 128 / DSPLIT;  // kv rows per block
  constexpr int DN = DMAX / DSPLIT;  // dK/dV columns per warpgroup
  constexpr int NCH = DN < 128 ? DN : 128;  // columns per dK/dV wgmma
  constexpr uint32_t kKVBytes = BKV * DMAX * 2;
  constexpr uint32_t kQBytes = BQ * DMAX * 2;
  static_assert(DMAX % 64 == 0 && DN % 64 == 0 && BQ % 16 == 0, "tiles");

  extern __shared__ uint8_t smem_raw[];
  const uint32_t sK = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sV = sK + kKVBytes;
  auto sQ = [&](int st) { return sV + kKVBytes + st * 2 * kQBytes; };
  auto sdO = [&](int st) { return sQ(st) + kQBytes; };
  // [STAGES][lse, delta][BQ] f32 after the Q and dO stages.
  const uint32_t sRows = sV + kKVBytes + 2 * STAGES * kQBytes;
  const float* rows =
      reinterpret_cast<float*>(smem_raw + (sRows - smem_u32(smem_raw)));

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int kv_sub = wg / DSPLIT;  // which 64 kv rows
  const int dpart = wg % DSPLIT;   // which DN columns of dK/dV
  const int warp = (tid % 128) / 32;
  const int g = (tid % 32) / 4;
  const int c4 = tid % 4;
  const int bkv = blockIdx.x;  // b * Hkv + kv_head
  const int b = bkv / Hkv;
  const int hk = bkv % Hkv;
  const int group = H / Hkv;
  const int k0 = blockIdx.y * BKV;
  const int kvrow0 = k0 + 64 * kv_sub + 16 * warp + g;  // and kvrow0 + 8

  const int nq = (S + BQ - 1) / BQ;
  // Causal: q tile t is live iff t*BQ + BQ - 1 >= k0, i.e. t >= k0 / BQ.
  const int t0 = causal ? k0 / BQ : 0;
  const int n_t = nq - t0;
  const int n_it = group * n_t;

  // Q, dO, lse and delta of step `it` (q head hk*group + it / n_t, q tile
  // t0 + it % n_t) into stage it % STAGES.
  auto load_q_side = [&](int it) {
    const int st = it % STAGES;
    const int h = hk * group + it / n_t;
    const int qt0 = (t0 + it % n_t) * BQ;
    load_tile<DMAX, BQ, NT>(sQ(st), q + b * qs.b + h * qs.h, qs.s, qt0, S, D,
                            tid);
    load_tile<DMAX, BQ, NT>(sdO(st), dout + b * dos.b + h * dos.h, dos.s,
                            qt0, S, D, tid);
    if (tid < 2 * BQ) {
      const int r = tid % BQ;
      const float* src = (tid < BQ ? lse : delta) +
                         (long long)(b * H + h) * S + qt0 + r;
      const bool ok = qt0 + r < S;
      cp_async4(sRows + 4 * (st * 2 * BQ + tid), ok ? src : lse, ok);
    }
  };

  // The ring: K and V with step 0, then one commit group per step.
  load_tile<DMAX, BKV, NT>(sK, k + b * ks.b + hk * ks.h, ks.s, k0, S, D, tid);
  load_tile<DMAX, BKV, NT>(sV, v + b * vs.b + hk * vs.h, vs.s, k0, S, D, tid);
#pragma unroll
  for (int it = 0; it < STAGES - 1; ++it) {
    if (it < n_it) load_q_side(it);
    cp_async_commit();
  }

  float acc_dk[DN / 2], acc_dv[DN / 2];
#pragma unroll
  for (int i = 0; i < DN / 2; ++i) {
    acc_dk[i] = 0.f;
    acc_dv[i] = 0.f;
  }
  const float sl2 = scale * kLog2e;

  for (int it = 0; it < n_it; ++it) {
    const int st = it % STAGES;
    if (it + STAGES - 1 < n_it) load_q_side(it + STAGES - 1);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();  // step it (and K, V) have landed
    fence_proxy_async();
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T for this warpgroup's 64 kv rows.
    float sT[BQ / 2], dpT[BQ / 2];
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) {
      sT[i] = 0.f;
      dpT[i] = 0.f;
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DMAX / 16; ++kk) {
      const uint32_t kv_off = (kk / 4) * BKV * 128 + kv_sub * 64 * 128 +
                              (kk % 4) * 32;
      const uint32_t q_off = (kk / 4) * BQ * 128 + (kk % 4) * 32;
      Wgmma<BQ>::ss(sT, desc_k_major(sK + kv_off),
                    desc_k_major(sQ(st) + q_off), kk > 0);
      Wgmma<BQ>::ss(dpT, desc_k_major(sV + kv_off),
                    desc_k_major(sdO(st) + q_off), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sT);
    fence_regs(dpT);

    // P^T and dS^T on the fragments.  Only the ragged last q tile and q
    // tiles that cross this warpgroup's causal diagonal need the mask.
    const int qt0 = (t0 + it % n_t) * BQ;
    const float* s_lse = rows + st * 2 * BQ;
    const float* s_delta = s_lse + BQ;
    if (qt0 + BQ > S || (causal && k0 + 64 * kv_sub + 63 > qt0))
      recompute_wgmma<true, BQ>(sT, dpT, s_lse, s_delta, qt0, 2 * c4, kvrow0,
                                S, causal, sl2, scale);
    else
      recompute_wgmma<false, BQ>(sT, dpT, s_lse, s_delta, qt0, 2 * c4,
                                 kvrow0, S, causal, sl2, scale);

    // dV += P^T dO and dK += dS^T Q, P^T and dS^T rounded to bf16 as the
    // A operands.
    uint32_t ap[BQ / 16][4], ads[BQ / 16][4];
    to_a_fragments<BQ>(sT, ap);
    to_a_fragments<BQ>(dpT, ads);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
      for (int nc = 0; nc < DN / NCH; ++nc) {
        const uint32_t off =
            kk * 2048 + (dpart * (DN / 64) + nc * (NCH / 64)) * BQ * 128;
        Wgmma<NCH>::rs(
            *reinterpret_cast<float(*)[NCH / 2]>(&acc_dv[nc * NCH / 2]),
            ap[kk], desc_mn_major(sdO(st) + off, BQ * 128));
        Wgmma<NCH>::rs(
            *reinterpret_cast<float(*)[NCH / 2]>(&acc_dk[nc * NCH / 2]),
            ads[kk], desc_mn_major(sQ(st) + off, BQ * 128));
      }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_dv);
    fence_regs(acc_dk);
    __syncthreads();  // every warpgroup is done with stage st
  }

  // dK, dV: contiguous [B, S, Hkv, D].
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = kvrow0 + 8 * r;
    if (row >= S) continue;
    const long long base = (((long long)b * S + row) * Hkv + hk) * D;
#pragma unroll
    for (int j = 0; j < DN / 8; ++j) {
      const int d = dpart * DN + 8 * j + 2 * c4;
      if (d < D) {
        *reinterpret_cast<__nv_bfloat162*>(dk + base + d) =
            __floats2bfloat162_rn(acc_dk[4 * j + 2 * r],
                                  acc_dk[4 * j + 2 * r + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv + base + d) =
            __floats2bfloat162_rn(acc_dv[4 * j + 2 * r],
                                  acc_dv[4 * j + 2 * r + 1]);
      }
    }
  }
}

template <int DMAX, int BQ, int DSPLIT>
cudaError_t launch_dkdv_wgmma(const Args& a, cudaStream_t stream) {
  using hopper::bf16;
  constexpr size_t smem = dkdv_wgmma_smem_bytes<DMAX, BQ, DSPLIT>();
  auto kern = flash_bwd_dkdv_kernel_wgmma<DMAX, BQ, DSPLIT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  constexpr int BKV = 128 / DSPLIT;
  const dim3 grid(a.B * a.Hkv, (a.S + BKV - 1) / BKV);
  if (grid.y > hopper::kMaxGridY) return cudaErrorInvalidValue;
  kern<<<grid, 256, smem, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse,
      a.delta, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.S, a.H,
      a.Hkv, a.D, a.qs, a.ks, a.vs, a.dos, a.scale, a.causal);
  return cudaGetLastError();
}

// bf16 dK/dV tiles per head-dim bucket, (block_q, block_k) = (BQ,
// 128 / DSPLIT); ops/flash_attention.py::BACKWARD_TILES["flash_bwd_dkdv"]
// ["bfloat16"] mirrors this table.  Shared memory: 66, 98 and 130 KB.
// 32-row q tiles at D <= 64 measured slower (PERF.md).
cudaError_t dispatch_dkdv_wgmma(const Args& a, cudaStream_t st) {
  if (!hopper::tensor_core_operand(a.q, a.qs, a.D) ||
      !hopper::tensor_core_operand(a.k, a.ks, a.D) ||
      !hopper::tensor_core_operand(a.v, a.vs, a.D) ||
      !hopper::tensor_core_operand(a.dout, a.dos, a.D))
    return cudaErrorInvalidValue;
  if (a.D <= 64) return launch_dkdv_wgmma<64, 64, 1>(a, st);
  if (a.D <= 128) return launch_dkdv_wgmma<128, 64, 2>(a, st);
  return launch_dkdv_wgmma<256, 32, 2>(a, st);
}

// ---- f32 dK/dV on the tensor cores, as split bf16 -------------------------

template <int DMAX, int BQ, int DSPLIT>
constexpr size_t dkdv_f32_smem_bytes() {
  // K and V [BKV x DMAX] and Q and dO [BQ x DMAX] as kSplitParts bf16
  // tiles each; the f32 staging tiles of Q and dO; STAGES stages of lse
  // and delta [BQ] f32; plus the slack that aligns the base.
  return (size_t)2 * hopper::kSplitParts * DMAX *
             (2 * (128 / DSPLIT) + 2 * BQ) +
         (size_t)8 * BQ * DMAX + 8 * hopper::STAGES * BQ + 1024;
}

template <int DMAX, int BQ, int DSPLIT>
__global__ void __launch_bounds__(256, 1) flash_bwd_dkdv_kernel_wgmma_f32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, int S, int H, int Hkv,
    int D, Strides qs, Strides ks, Strides vs, Strides dos, float scale,
    int causal) {
  using namespace hopper;
  constexpr int NT = 256;
  constexpr int BKV = 128 / DSPLIT;  // kv rows per block
  constexpr int DN = DMAX / DSPLIT;  // dK/dV columns per warpgroup
  constexpr int NCH = DN < 128 ? DN : 128;  // columns per dK/dV wgmma
  constexpr int P = kSplitParts;
  constexpr uint32_t kKVBytes = BKV * DMAX * 2;  // one bf16 part
  constexpr uint32_t kQBytes = BQ * DMAX * 2;
  constexpr uint32_t kStageBytes = BQ * DMAX * 4;
  static_assert(DMAX % 64 == 0 && DN % 64 == 0 && BQ % 16 == 0, "tiles");

  // The parts of K, V, Q and dO (part i of K at sK + i * kKVBytes, ...),
  // then the f32 staging tiles of Q and dO.
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sK = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sV = sK + P * kKVBytes;
  const uint32_t sQ = sV + P * kKVBytes;
  const uint32_t sdO = sQ + P * kQBytes;
  const uint32_t sQf = sdO + P * kQBytes;
  const uint32_t sdOf = sQf + kStageBytes;
  // [STAGES][lse, delta][BQ] f32 after the staging tiles.
  const uint32_t sRows = sdOf + kStageBytes;
  const float* rows =
      reinterpret_cast<float*>(smem_raw + (sRows - smem_u32(smem_raw)));

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int kv_sub = wg / DSPLIT;  // which 64 kv rows
  const int dpart = wg % DSPLIT;   // which DN columns of dK/dV
  const int warp = (tid % 128) / 32;
  const int g = (tid % 32) / 4;
  const int c4 = tid % 4;
  const int bkv = blockIdx.x;  // b * Hkv + kv_head
  const int b = bkv / Hkv;
  const int hk = bkv % Hkv;
  const int group = H / Hkv;
  const int k0 = blockIdx.y * BKV;
  const int kvrow0 = k0 + 64 * kv_sub + 16 * warp + g;  // and kvrow0 + 8

  const int nq = (S + BQ - 1) / BQ;
  // Causal: q tile t is live iff t*BQ + BQ - 1 >= k0, i.e. t >= k0 / BQ.
  const int t0 = causal ? k0 / BQ : 0;
  const int n_t = nq - t0;
  const int n_it = group * n_t;

  // Q and dO of step `it` (q head hk*group + it / n_t, q tile t0 + it %
  // n_t) into the staging tiles, lse and delta into stage it % STAGES.
  auto stage_q_side = [&](int it) {
    const int st = it % STAGES;
    const int h = hk * group + it / n_t;
    const int qt0 = (t0 + it % n_t) * BQ;
    stage_tile_f32<DMAX, BQ, NT>(sQf, q + b * qs.b + h * qs.h, qs.s, qt0, S,
                                 D, tid);
    stage_tile_f32<DMAX, BQ, NT>(sdOf, dout + b * dos.b + h * dos.h, dos.s,
                                 qt0, S, D, tid);
    if (tid < 2 * BQ) {
      const int r = tid % BQ;
      const float* src = (tid < BQ ? lse : delta) +
                         (long long)(b * H + h) * S + qt0 + r;
      const bool ok = qt0 + r < S;
      cp_async4(sRows + 4 * (st * 2 * BQ + tid), ok ? src : lse, ok);
    }
    cp_async_commit();
  };

  // Step 0 lands while K and V are split.
  if (n_it > 0) stage_q_side(0);
  split_tile_global<DMAX, BKV, NT>(sK, k + b * ks.b + hk * ks.h, ks.s, k0,
                                   S, D, tid);
  split_tile_global<DMAX, BKV, NT>(sV, v + b * vs.b + hk * vs.h, vs.s, k0,
                                   S, D, tid);

  float acc_dk[DN / 2], acc_dv[DN / 2];
#pragma unroll
  for (int i = 0; i < DN / 2; ++i) {
    acc_dk[i] = 0.f;
    acc_dv[i] = 0.f;
  }
  const float sl2 = scale * kLog2e;

  for (int it = 0; it < n_it; ++it) {
    const int st = it % STAGES;
    cp_async_wait<0>();
    __syncthreads();  // step it is staged; every warpgroup is done with it-1
    split_tile_staged<DMAX, BQ, NT>(sQ, sQf, tid);
    split_tile_staged<DMAX, BQ, NT>(sdO, sdOf, tid);
    fence_proxy_async();
    __syncthreads();  // the part tiles are visible to wgmma; staging is free
    if (it + 1 < n_it) stage_q_side(it + 1);

    // S^T = K Q^T and dP^T = V dO^T for this warpgroup's 64 kv rows: Ki Qj
    // and Vi dOj over i + j < P.
    float sT[BQ / 2], dpT[BQ / 2];
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) {
      sT[i] = 0.f;
      dpT[i] = 0.f;
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DMAX / 16; ++kk) {
      const uint32_t kv_off = (kk / 4) * BKV * 128 + kv_sub * 64 * 128 +
                              (kk % 4) * 32;
      const uint32_t q_off = (kk / 4) * BQ * 128 + (kk % 4) * 32;
#pragma unroll
      for (int i = 0; i < P; ++i)
#pragma unroll
        for (int j = 0; i + j < P; ++j) {
          Wgmma<BQ>::ss(sT, desc_k_major(sK + i * kKVBytes + kv_off),
                        desc_k_major(sQ + j * kQBytes + q_off),
                        kk + i + j > 0);
          Wgmma<BQ>::ss(dpT, desc_k_major(sV + i * kKVBytes + kv_off),
                        desc_k_major(sdO + j * kQBytes + q_off),
                        kk + i + j > 0);
        }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sT);
    fence_regs(dpT);

    // P^T and dS^T on the fragments, as in the bf16 kernel.
    const int qt0 = (t0 + it % n_t) * BQ;
    const float* s_lse = rows + st * 2 * BQ;
    const float* s_delta = s_lse + BQ;
    if (qt0 + BQ > S || (causal && k0 + 64 * kv_sub + 63 > qt0))
      recompute_wgmma<true, BQ>(sT, dpT, s_lse, s_delta, qt0, 2 * c4, kvrow0,
                                S, causal, sl2, scale);
    else
      recompute_wgmma<false, BQ>(sT, dpT, s_lse, s_delta, qt0, 2 * c4,
                                 kvrow0, S, causal, sl2, scale);

    // dV += P^T dO and dK += dS^T Q: (P^T)i dOj and (dS^T)i Qj over
    // i + j < P, P^T and dS^T split in registers as the A operands.
    uint32_t ap[P][BQ / 16][4], ads[P][BQ / 16][4];
    split_fragments<BQ>(sT, ap);
    split_fragments<BQ>(dpT, ads);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
      for (int nc = 0; nc < DN / NCH; ++nc) {
        const uint32_t off =
            kk * 2048 + (dpart * (DN / 64) + nc * (NCH / 64)) * BQ * 128;
        float(&dv_acc)[NCH / 2] =
            *reinterpret_cast<float(*)[NCH / 2]>(&acc_dv[nc * NCH / 2]);
        float(&dk_acc)[NCH / 2] =
            *reinterpret_cast<float(*)[NCH / 2]>(&acc_dk[nc * NCH / 2]);
#pragma unroll
        for (int i = 0; i < P; ++i)
#pragma unroll
          for (int j = 0; i + j < P; ++j) {
            Wgmma<NCH>::rs(dv_acc, ap[i][kk],
                           desc_mn_major(sdO + j * kQBytes + off, BQ * 128));
            Wgmma<NCH>::rs(dk_acc, ads[i][kk],
                           desc_mn_major(sQ + j * kQBytes + off, BQ * 128));
          }
      }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_dv);
    fence_regs(acc_dk);
  }

  // dK, dV: contiguous [B, S, Hkv, D].
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = kvrow0 + 8 * r;
    if (row >= S) continue;
    const long long base = (((long long)b * S + row) * Hkv + hk) * D;
#pragma unroll
    for (int j = 0; j < DN / 8; ++j) {
      const int d = dpart * DN + 8 * j + 2 * c4;
      if (d < D) {
        *reinterpret_cast<float2*>(dk + base + d) =
            make_float2(acc_dk[4 * j + 2 * r], acc_dk[4 * j + 2 * r + 1]);
        *reinterpret_cast<float2*>(dv + base + d) =
            make_float2(acc_dv[4 * j + 2 * r], acc_dv[4 * j + 2 * r + 1]);
      }
    }
  }
}

template <int DMAX, int BQ, int DSPLIT>
cudaError_t launch_dkdv_wgmma_f32(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = dkdv_f32_smem_bytes<DMAX, BQ, DSPLIT>();
  auto kern = flash_bwd_dkdv_kernel_wgmma_f32<DMAX, BQ, DSPLIT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  constexpr int BKV = 128 / DSPLIT;
  const dim3 grid(a.B * a.Hkv, (a.S + BKV - 1) / BKV);
  if (grid.y > hopper::kMaxGridY) return cudaErrorInvalidValue;
  kern<<<grid, 256, smem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, static_cast<float*>(a.dk), static_cast<float*>(a.dv),
      a.S, a.H, a.Hkv, a.D, a.qs, a.ks, a.vs, a.dos, a.scale, a.causal);
  return cudaGetLastError();
}

// f32 dK/dV tiles per head-dim bucket, (block_q, block_k) = (BQ,
// 128 / DSPLIT); ops/flash_attention.py::BACKWARD_TILES["flash_bwd_dkdv"]
// ["float32"] mirrors this table.  Shared memory: 130, 130 and 194 KB.
// At D = 128 the 64-row q tile of bf16 spills (the split's extra A
// fragments), a 32-row one does not; at D = 256 a 16-row q tile is what
// fits shared memory.
cudaError_t dispatch_dkdv_wgmma_f32(const Args& a, cudaStream_t st) {
  if (!hopper::tensor_core_operand(a.q, a.qs, a.D, 4) ||
      !hopper::tensor_core_operand(a.k, a.ks, a.D, 4) ||
      !hopper::tensor_core_operand(a.v, a.vs, a.D, 4) ||
      !hopper::tensor_core_operand(a.dout, a.dos, a.D, 4))
    return cudaErrorInvalidValue;
  if (a.D <= 64) return launch_dkdv_wgmma_f32<64, 64, 1>(a, st);
  if (a.D <= 128) return launch_dkdv_wgmma_f32<128, 32, 2>(a, st);
  return launch_dkdv_wgmma_f32<256, 16, 2>(a, st);
}

// ---- bf16 dQ on the tensor cores -----------------------------------------

template <int DMAX, int BK, int NWG>
constexpr size_t dq_wgmma_smem_bytes() {
  // Q and dO [64 * NWG x DMAX] and STAGES stages of K and V [BK x DMAX],
  // bf16, plus the slack that aligns the base to 1024 bytes.
  return (size_t)2 * DMAX * (2 * 64 * NWG + 2 * hopper::STAGES * BK) + 1024;
}

// P and dS of one (q tile, kv tile) pair on this thread's fragments (q
// rows row0 + 8*(e/2), kv columns k0 + 8j + 2*c4 + e%2), in place of S
// and dP.  `lse2` is each row's lse * log2(e), +inf where lse = -inf, so
// that such a row gives P = 0 with no test; MASK applies the ragged-edge
// and causal rules.
template <bool MASK, int BK>
__device__ __forceinline__ void recompute_rows_wgmma(
    float (&s)[BK / 2], float (&dp)[BK / 2], const float (&lse2)[2],
    const float (&dl)[2], int k0, int col0, int row0, int S, int causal,
    float sl2, float scale) {
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      float p = hopper::fast_exp2(s[4 * j + e] * sl2 - lse2[r]);
      if (MASK) {
        const int col = k0 + 8 * j + col0 + (e & 1);
        if (col >= S || (causal && col > row0 + 8 * r)) p = 0.f;
      }
      s[4 * j + e] = p;
      dp[4 * j + e] = p * (dp[4 * j + e] - dl[r]) * scale;
    }
}

template <int DMAX, int BK, int NWG>
__global__ void __launch_bounds__(128 * NWG, DMAX == 64 ? 2 : 1)
    flash_bwd_dq_kernel_wgmma(
    const hopper::bf16* __restrict__ q, const hopper::bf16* __restrict__ k,
    const hopper::bf16* __restrict__ v, const hopper::bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    hopper::bf16* __restrict__ dq, int S, int H, int Hkv, int D, Strides qs,
    Strides ks, Strides vs, Strides dos, float scale, int causal) {
  using namespace hopper;
  constexpr int BQ = 64 * NWG;
  constexpr int NT = 128 * NWG;
  constexpr int NCH = DMAX < 128 ? DMAX : 128;  // dQ columns per dS K wgmma
  constexpr uint32_t kQBytes = BQ * DMAX * 2;
  constexpr uint32_t kKVBytes = BK * DMAX * 2;
  static_assert(DMAX % 64 == 0 && BK % 16 == 0, "tiles");

  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sdO = sQ + kQBytes;
  auto sK = [&](int st) { return sdO + kQBytes + st * 2 * kKVBytes; };
  auto sV = [&](int st) { return sK(st) + kKVBytes; };

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int g = (tid % 32) / 4;  // row within the warp's 8-row half
  const int c4 = tid % 4;        // column pair within an 8-column chunk
  const int bh = blockIdx.x;     // b * H + head
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / (H / Hkv);  // _kv_row_map: kv row b*Hkv + h // group
  const int q0 = blockIdx.y * BQ;
  const int row0 = q0 + 64 * wg + 16 * warp + g;  // and row0 + 8

  const bf16* kb = k + b * ks.b + hk * ks.h;
  const bf16* vb = v + b * vs.b + hk * vs.h;
  auto load_kv = [&](int t) {
    const int st = t % STAGES;
    load_tile<DMAX, BK, NT>(sK(st), kb, ks.s, t * BK, S, D, tid);
    load_tile<DMAX, BK, NT>(sV(st), vb, vs.s, t * BK, S, D, tid);
  };

  int n_kv = (S + BK - 1) / BK;
  if (causal) {
    // kv tile t is live iff t*BK <= q0 + BQ - 1.
    n_kv = min(n_kv, (q0 + BQ - 1) / BK + 1);
  }

  // The ring: Q and dO with kv tile 0, then one commit group per kv tile.
  load_tile<DMAX, BQ, NT>(sQ, q + b * qs.b + h * qs.h, qs.s, q0, S, D, tid);
  load_tile<DMAX, BQ, NT>(sdO, dout + b * dos.b + h * dos.h, dos.s, q0, S,
                          D, tid);
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < n_kv) load_kv(t);
    cp_async_commit();
  }

  // lse (log2 domain) and delta of this thread's two rows; rows past S
  // take lse = -inf, which zeroes their P and dS.
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const float l = row < S ? lse[(long long)bh * S + row] : -INFINITY;
    lse2[r] = isfinite(l) ? l * kLog2e : INFINITY;
    dl[r] = row < S ? delta[(long long)bh * S + row] : 0.f;
  }

  float acc[DMAX / 2];
#pragma unroll
  for (int i = 0; i < DMAX / 2; ++i) acc[i] = 0.f;
  const float sl2 = scale * kLog2e;

  for (int t = 0; t < n_kv; ++t) {
    const int st = t % STAGES;
    if (t + STAGES - 1 < n_kv) load_kv(t + STAGES - 1);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();  // tile t (and Q, dO) have landed
    fence_proxy_async();
    __syncthreads();

    // S = Q K^T and dP = dO V^T for this warpgroup's 64 rows.
    float s[BK / 2], dp[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      s[i] = 0.f;
      dp[i] = 0.f;
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DMAX / 16; ++kk) {
      const uint32_t col = (kk % 4) * 32;  // within the 128-byte row
      const uint32_t q_off = (kk / 4) * BQ * 128 + wg * 64 * 128 + col;
      const uint32_t kv_off = (kk / 4) * BK * 128 + col;
      Wgmma<BK>::ss(s, desc_k_major(sQ + q_off),
                    desc_k_major(sK(st) + kv_off), kk > 0);
      Wgmma<BK>::ss(dp, desc_k_major(sdO + q_off),
                    desc_k_major(sV(st) + kv_off), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // P and dS on the fragments.  Only the ragged last kv tile and kv
    // tiles that cross this warpgroup's causal diagonal need the mask.
    const int k0 = t * BK;
    if (k0 + BK > S || (causal && k0 + BK - 1 > q0 + 64 * wg))
      recompute_rows_wgmma<true, BK>(s, dp, lse2, dl, k0, 2 * c4, row0, S,
                                     causal, sl2, scale);
    else
      recompute_rows_wgmma<false, BK>(s, dp, lse2, dl, k0, 2 * c4, row0, S,
                                      causal, sl2, scale);

    // dQ += dS K, dS rounded to bf16 as the A operand and K read MN-major
    // from the same tile.
    uint32_t ads[BK / 16][4];
    to_a_fragments<BK>(dp, ads);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int nc = 0; nc < DMAX / NCH; ++nc) {
        float(&o)[NCH / 2] =
            *reinterpret_cast<float(*)[NCH / 2]>(&acc[nc * NCH / 2]);
        const uint64_t dk = desc_mn_major(
            sK(st) + kk * 2048 + nc * (NCH / 64) * BK * 128, BK * 128);
        Wgmma<NCH>::rs(o, ads[kk], dk);
      }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncthreads();  // every warpgroup is done with stage st
  }

  // dQ: contiguous [B, S, H, D].
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= S) continue;
    bf16* out = dq + (((long long)b * S + row) * H + h) * (long long)D;
#pragma unroll
    for (int j = 0; j < DMAX / 8; ++j) {
      const int d = 8 * j + 2 * c4;
      if (d < D)
        *reinterpret_cast<__nv_bfloat162*>(out + d) = __floats2bfloat162_rn(
            acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    }
  }
}

template <int DMAX, int BK, int NWG>
cudaError_t launch_dq_wgmma(const Args& a, cudaStream_t stream) {
  using hopper::bf16;
  constexpr size_t smem = dq_wgmma_smem_bytes<DMAX, BK, NWG>();
  auto kern = flash_bwd_dq_kernel_wgmma<DMAX, BK, NWG>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.H, (a.S + 64 * NWG - 1) / (64 * NWG));
  if (grid.y > hopper::kMaxGridY) return cudaErrorInvalidValue;
  kern<<<grid, 128 * NWG, smem, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse,
      a.delta, static_cast<bf16*>(a.dq), a.S, a.H, a.Hkv, a.D, a.qs, a.ks,
      a.vs, a.dos, a.scale, a.causal);
  return cudaGetLastError();
}

// bf16 dQ tiles per head-dim bucket, (block_q, block_k) = (64 * NWG, BK);
// ops/flash_attention.py::BACKWARD_TILES["flash_bwd_dq"]["bfloat16"]
// mirrors this table.  Shared memory: 49, 129 and 129 KB.  At D <= 64 the
// 32-column kv tile and the launch bound keep a thread at 128 registers
// without spilling, so two blocks share an SM and one block's softmax
// overlaps the other's products (PERF.md: 0.26 ms at the flagship shape
// against 0.31 for one block of 64 kv columns; 64 columns under the same
// bound spill).  At D = 256 one warpgroup of 64 rows and a 32-column kv
// tile keep dQ (128 registers a thread), S and dP within 255.
cudaError_t dispatch_dq_wgmma(const Args& a, cudaStream_t st) {
  if (!hopper::tensor_core_operand(a.q, a.qs, a.D) ||
      !hopper::tensor_core_operand(a.k, a.ks, a.D) ||
      !hopper::tensor_core_operand(a.v, a.vs, a.D) ||
      !hopper::tensor_core_operand(a.dout, a.dos, a.D))
    return cudaErrorInvalidValue;
  if (a.D <= 64) return launch_dq_wgmma<64, 32, 2>(a, st);
  if (a.D <= 128) return launch_dq_wgmma<128, 64, 2>(a, st);
  return launch_dq_wgmma<256, 32, 1>(a, st);
}

// ---- f32 dQ on the tensor cores, as split bf16 ---------------------------

template <int DMAX, int BK, int NWG>
constexpr size_t dq_f32_smem_bytes() {
  // Q and dO [64 * NWG x DMAX] and K and V [BK x DMAX] as kSplitParts bf16
  // tiles each, the f32 staging tiles of K and V, and the slack that
  // aligns the base.
  return (size_t)2 * hopper::kSplitParts * DMAX * (2 * 64 * NWG + 2 * BK) +
         (size_t)8 * BK * DMAX + 1024;
}

template <int DMAX, int BK, int NWG>
__global__ void __launch_bounds__(128 * NWG, DMAX == 64 ? 2 : 1)
    flash_bwd_dq_kernel_wgmma_f32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, int S, int H, int Hkv, int D, Strides qs,
    Strides ks, Strides vs, Strides dos, float scale, int causal) {
  using namespace hopper;
  constexpr int BQ = 64 * NWG;
  constexpr int NT = 128 * NWG;
  constexpr int NCH = DMAX < 128 ? DMAX : 128;  // dQ columns per dS K wgmma
  constexpr int P = kSplitParts;
  constexpr uint32_t kQBytes = BQ * DMAX * 2;  // one bf16 part
  constexpr uint32_t kKVBytes = BK * DMAX * 2;
  constexpr uint32_t kStageBytes = BK * DMAX * 4;
  static_assert(DMAX % 64 == 0 && BK % 16 == 0, "tiles");

  // The parts of Q, dO, K and V (part i of Q at sQ + i * kQBytes, ...),
  // then the f32 staging tiles of K and V.
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sdO = sQ + P * kQBytes;
  const uint32_t sK = sdO + P * kQBytes;
  const uint32_t sV = sK + P * kKVBytes;
  const uint32_t sKf = sV + P * kKVBytes;
  const uint32_t sVf = sKf + kStageBytes;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int g = (tid % 32) / 4;  // row within the warp's 8-row half
  const int c4 = tid % 4;        // column pair within an 8-column chunk
  const int bh = blockIdx.x;     // b * H + head
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / (H / Hkv);  // _kv_row_map: kv row b*Hkv + h // group
  const int q0 = blockIdx.y * BQ;
  const int row0 = q0 + 64 * wg + 16 * warp + g;  // and row0 + 8

  const float* kb = k + b * ks.b + hk * ks.h;
  const float* vb = v + b * vs.b + hk * vs.h;
  auto stage_kv = [&](int t) {
    stage_tile_f32<DMAX, BK, NT>(sKf, kb, ks.s, t * BK, S, D, tid);
    stage_tile_f32<DMAX, BK, NT>(sVf, vb, vs.s, t * BK, S, D, tid);
    cp_async_commit();
  };

  int n_kv = (S + BK - 1) / BK;
  if (causal) {
    // kv tile t is live iff t*BK <= q0 + BQ - 1.
    n_kv = min(n_kv, (q0 + BQ - 1) / BK + 1);
  }

  // kv tile 0 lands while Q and dO are split.
  stage_kv(0);
  split_tile_global<DMAX, BQ, NT>(sQ, q + b * qs.b + h * qs.h, qs.s, q0, S,
                                  D, tid);
  split_tile_global<DMAX, BQ, NT>(sdO, dout + b * dos.b + h * dos.h, dos.s,
                                  q0, S, D, tid);

  // lse (log2 domain) and delta of this thread's two rows, as in the bf16
  // kernel: lse2 = +inf for rows past S and rows with lse = -inf.
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const float l = row < S ? lse[(long long)bh * S + row] : -INFINITY;
    lse2[r] = isfinite(l) ? l * kLog2e : INFINITY;
    dl[r] = row < S ? delta[(long long)bh * S + row] : 0.f;
  }

  float acc[DMAX / 2];
#pragma unroll
  for (int i = 0; i < DMAX / 2; ++i) acc[i] = 0.f;
  const float sl2 = scale * kLog2e;

  for (int t = 0; t < n_kv; ++t) {
    cp_async_wait<0>();
    __syncthreads();  // tile t is staged; every warpgroup is done with t - 1
    split_tile_staged<DMAX, BK, NT>(sK, sKf, tid);
    split_tile_staged<DMAX, BK, NT>(sV, sVf, tid);
    fence_proxy_async();
    __syncthreads();  // the part tiles are visible to wgmma; staging is free
    if (t + 1 < n_kv) stage_kv(t + 1);

    // S = Q K^T and dP = dO V^T for this warpgroup's 64 rows: Qi Kj and
    // dOi Vj over i + j < P.
    float s[BK / 2], dp[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      s[i] = 0.f;
      dp[i] = 0.f;
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DMAX / 16; ++kk) {
      const uint32_t col = (kk % 4) * 32;  // within the 128-byte row
      const uint32_t q_off = (kk / 4) * BQ * 128 + wg * 64 * 128 + col;
      const uint32_t kv_off = (kk / 4) * BK * 128 + col;
#pragma unroll
      for (int i = 0; i < P; ++i)
#pragma unroll
        for (int j = 0; i + j < P; ++j) {
          Wgmma<BK>::ss(s, desc_k_major(sQ + i * kQBytes + q_off),
                        desc_k_major(sK + j * kKVBytes + kv_off),
                        kk + i + j > 0);
          Wgmma<BK>::ss(dp, desc_k_major(sdO + i * kQBytes + q_off),
                        desc_k_major(sV + j * kKVBytes + kv_off),
                        kk + i + j > 0);
        }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // P and dS on the fragments, as in the bf16 kernel.
    const int k0 = t * BK;
    if (k0 + BK > S || (causal && k0 + BK - 1 > q0 + 64 * wg))
      recompute_rows_wgmma<true, BK>(s, dp, lse2, dl, k0, 2 * c4, row0, S,
                                     causal, sl2, scale);
    else
      recompute_rows_wgmma<false, BK>(s, dp, lse2, dl, k0, 2 * c4, row0, S,
                                      causal, sl2, scale);

    // dQ += dS K: dSi Kj over i + j < P, dS split in registers as the A
    // operands and K's parts read MN-major from the same tiles.
    uint32_t ads[P][BK / 16][4];
    split_fragments<BK>(dp, ads);
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
            Wgmma<NCH>::rs(o, ads[i][kk],
                           desc_mn_major(sK + j * kKVBytes + off, BK * 128));
      }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }

  // dQ: contiguous [B, S, H, D].
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= S) continue;
    float* out = dq + (((long long)b * S + row) * H + h) * (long long)D;
#pragma unroll
    for (int j = 0; j < DMAX / 8; ++j) {
      const int d = 8 * j + 2 * c4;
      if (d < D)
        *reinterpret_cast<float2*>(out + d) =
            make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    }
  }
}

template <int DMAX, int BK, int NWG>
cudaError_t launch_dq_wgmma_f32(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = dq_f32_smem_bytes<DMAX, BK, NWG>();
  auto kern = flash_bwd_dq_kernel_wgmma_f32<DMAX, BK, NWG>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.H, (a.S + 64 * NWG - 1) / (64 * NWG));
  if (grid.y > hopper::kMaxGridY) return cudaErrorInvalidValue;
  kern<<<grid, 128 * NWG, smem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, static_cast<float*>(a.dq), a.S, a.H, a.Hkv, a.D, a.qs,
      a.ks, a.vs, a.dos, a.scale, a.causal);
  return cudaGetLastError();
}

// f32 dQ tiles per head-dim bucket, (block_q, block_k) = (64 * NWG, BK);
// ops/flash_attention.py::BACKWARD_TILES["flash_bwd_dq"]["float32"]
// mirrors this table.  Shared memory: 97, 193 and 193 KB.  At D <= 64 two
// blocks share an SM (128 registers, no spill), as for the bf16 dQ and the
// f32 forward; one block with a 64-column kv tile measured 5 % slower
// (PERF.md).  At D = 128 the 32-column kv tile takes one SM (a 64-column
// one would need 257 KB).  At D = 256 one warpgroup and a 16-column kv
// tile fit the part and staging tiles; it spills, but a 32-column tile
// split straight from global memory spilled more and ran 1.7x slower.
cudaError_t dispatch_dq_wgmma_f32(const Args& a, cudaStream_t st) {
  if (!hopper::tensor_core_operand(a.q, a.qs, a.D, 4) ||
      !hopper::tensor_core_operand(a.k, a.ks, a.D, 4) ||
      !hopper::tensor_core_operand(a.v, a.vs, a.D, 4) ||
      !hopper::tensor_core_operand(a.dout, a.dos, a.D, 4))
    return cudaErrorInvalidValue;
  if (a.D <= 64) return launch_dq_wgmma_f32<64, 32, 2>(a, st);
  if (a.D <= 128) return launch_dq_wgmma_f32<128, 32, 2>(a, st);
  return launch_dq_wgmma_f32<256, 16, 1>(a, st);
}
int check(const Args& a) {
  if (a.B < 1 || a.S < 1 || a.H < 1 || a.Hkv < 1 || a.H % a.Hkv != 0 ||
      a.D < 1 || a.D > 256 || (long long)a.B * a.H > hopper::kMaxGridX)
    return (int)cudaErrorInvalidValue;
  return 0;
}

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dq, void* dk,
               void* dv, int B, int S, int H, int Hkv, int D,
               const long long* st, float scale, int causal) {
  return Args{q, k, v, dout, lse, delta, dq, dk, dv, B, S, H, Hkv, D,
              Strides{st[0], st[1], st[2], st[3]},
              Strides{st[4], st[5], st[6], st[7]},
              Strides{st[8], st[9], st[10], st[11]},
              Strides{st[12], st[13], st[14], st[15]},
              scale, causal};
}

}  // namespace

extern "C" {

// Both return a cudaError_t: 0 when the launch was accepted.  `strides`
// holds 16 element strides, (b, s, h, d) of q, k, v and dout in turn.
// lse and delta are contiguous [B*H, S] f32; dk and dv are contiguous
// [B, S, Hkv, D] and dq contiguous [B, S, H, D], in the input dtype.
// Inputs must satisfy tensor_core_operand (cudaErrorInvalidValue
// otherwise).
int dml_flash_bwd_dkdv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       void* dk, void* dv, int B, int S, int H, int Hkv, int D,
                       const long long* strides, float scale, int causal,
                       int is_bf16, void* stream) {
  const Args a = make_args(q, k, v, dout, lse, delta, nullptr, dk, dv, B, S,
                           H, Hkv, D, strides, scale, causal);
  if (int err = check(a)) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) return (int)dispatch_dkdv_wgmma(a, st);
  return (int)dispatch_dkdv_wgmma_f32(a, st);
}

int dml_flash_bwd_dq(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     void* dq, int B, int S, int H, int Hkv, int D,
                     const long long* strides, float scale, int causal,
                     int is_bf16, void* stream) {
  const Args a = make_args(q, k, v, dout, lse, delta, dq, nullptr, nullptr, B,
                           S, H, Hkv, D, strides, scale, causal);
  if (int err = check(a)) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) return (int)dispatch_dq_wgmma(a, st);
  return (int)dispatch_dq_wgmma_f32(a, st);
}

const char* dml_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
