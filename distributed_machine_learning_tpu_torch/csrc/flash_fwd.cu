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
// Design.  One thread block per (batch*head, q tile); a loop over kv tiles
// takes the place of the TPU grid's sequential kv axis.  Each kv tile is
// staged in shared memory as f32 (k transposed), scores and the P.V
// product run as f32 FMAs from registers, and nothing of size S x S ever
// reaches device memory.  Tensors are read through their element strides
// ([B, S, H, D] in any layout, no transpose copy) and the ragged edges of
// S and D are masked, so any S and any D in 1..256 work.
//
// Bound.  At the flagship shape (B=8, S=2048, H=8, D=64, bf16) the work is
// 4*B*H*S^2*D = 68.7 GFLOP against ~68 MB of tensor traffic: the function
// is bound by operations.  This first version uses CUDA-core FMAs, not the
// tensor cores, so it runs far from that bound; wgmma/TMA tiles are the
// next step.  Its measured time sits in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kColGroups = 8;   // threads sharing one q row group
constexpr int kRowGroups = 16;  // q row groups per block
constexpr int kThreads = kColGroups * kRowGroups;

struct Strides {
  long long b, s, h, d;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype(bf16)
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
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / (H / Hkv);  // _kv_row_map: kv row b*Hkv + h // group
  const int q0 = blockIdx.x * BQ;

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
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, S, H, Hkv, D, qs,
      ks, vs, scale, causal);
  return cudaGetLastError();
}

// Tiles per head-dim bucket; ops/flash_attention.py::KERNEL_TILES mirrors
// this table.  Untuned: the first correct choice that fits shared memory
// (the largest, D <= 256, takes 181 KB).
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
// lse a contiguous [B*H, S] f32 tensor.
int dml_flash_fwd(const void* q, const void* k, const void* v, void* o,
                  float* lse, int B, int S, int H, int Hkv, int D,
                  long long qsb, long long qss, long long qsh, long long qsd,
                  long long ksb, long long kss, long long ksh, long long ksd,
                  long long vsb, long long vss, long long vsh, long long vsd,
                  float scale, int causal, int is_bf16, void* stream) {
  if (B < 1 || S < 1 || H < 1 || Hkv < 1 || H % Hkv != 0 || D < 1 ||
      D > 256 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const Strides qs{qsb, qss, qsh, qsd};
  const Strides ks{ksb, kss, ksh, ksd};
  const Strides vs{vsb, vss, vsh, vsd};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)dispatch<__nv_bfloat16>(q, k, v, o, lse, B, S, H, Hkv, D, qs,
                                        ks, vs, scale, causal, st);
  return (int)dispatch<float>(q, k, v, o, lse, B, S, H, Hkv, D, qs, ks, vs,
                              scale, causal, st);
}

const char* dml_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
