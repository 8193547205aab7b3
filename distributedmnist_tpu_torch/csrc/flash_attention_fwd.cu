// K1: flash-attention forward for Hopper (sm_90a), plain CUDA C++.
//
// Replaces: distributedmnist_tpu/ops/pallas_attention.py _attn_kernel,
// launched there by _forward through the entry flash_attention_bshd:
// the inference forward (save_lse=False, entry dmt_flash_attention_fwd)
// and the training forward of the custom VJP (save_lse=True, entry
// dmt_flash_attention_fwd_lse, "K1-lse"), which also writes each query
// row's log-sum-exp m + log(l) for the backward kernels
// (csrc/flash_attention_bwd.cu). The TPU kernel broadcasts lse over 128
// lanes, a TPU tiling artefact; here it is one float32 per row, laid
// out [batch, heads, seq]. It computes exact softmax(q.k^T * scale).v
// over the model layout [batch, seq, heads, head_dim] with a float32
// online softmax, causal key tiles above the diagonal skipped, and keys
// past the sequence end masked with the finite -1e30.
//
// What bounds it on this card: at the decode-serving prefill shapes
// (s <= 512, 16 heads of 128, one prompt) the whole call moves only a
// few MB and does ~1 GFLOP, so it is bound by device-memory traffic and
// launch cost, not by arithmetic. The design reads each Q row once and
// each K/V tile once per 64-row query tile (one HBM pass over K/V per
// query tile, the flash-attention traffic shape), keeps the running
// max / denominator / accumulator in registers so the [s, s] score
// matrix never leaves the SM, and walks only the key tiles at or below
// the causal diagonal. It uses the CUDA cores in float32 (no tensor
// cores yet): simple and exact first; wgmma/TMA are later work.
//
// Layout: one thread block per (query tile of 64 rows, head, batch);
// 8 warps, 8 query rows per warp. The sequential "arbitrary" grid axis
// of the TPU kernel, whose accumulator carried across grid steps,
// becomes the loop over key tiles inside the block. Key tiles are 32
// wide: lane j of a warp owns key j of the tile for the scores and
// column slice {lane + 32 i} of the output for the P.V product.
// Inputs are read through their strides (the model passes q = qkv[:, :,
// 0], a strided view), so no copy is made before the call; the last
// dimension must be contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBlockM = 64;  // query rows per thread block
constexpr int kBlockN = 32;  // keys per shared-memory tile (one per lane)
constexpr int kWarps = 8;
constexpr int kRowsPerWarp = kBlockM / kWarps;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

template <int D>
constexpr size_t smem_bytes() {
  // Q tile [64][D], K tile [32][D + 1] (the +1 pad makes lane j's row
  // walk conflict-free across banks), V tile [32][D], all float32.
  return sizeof(float) *
         (kBlockM * D + kBlockN * (D + 1) + kBlockN * D);
}

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int s,
                     int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
                     int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
                     int64_t v_sh, int64_t o_sb, int64_t o_ss, int64_t o_sh,
                     float scale, int causal, float* __restrict__ lse) {
  constexpr int DPL = D / 32;  // output columns per lane
  extern __shared__ float smem[];
  float* qs = smem;                         // [kBlockM][D]
  float* ks = qs + kBlockM * D;             // [kBlockN][D + 1]
  float* vs = ks + kBlockN * (D + 1);       // [kBlockN][D]

  const int q0 = blockIdx.x * kBlockM;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  const T* qb = q + batch * q_sb + head * q_sh;
  const T* kb = k + batch * k_sb + head * k_sh;
  const T* vb = v + batch * v_sb + head * v_sh;
  T* ob = o + batch * o_sb + head * o_sh;

  for (int idx = tid; idx < kBlockM * D; idx += kWarps * 32) {
    const int r = idx / D, c = idx - (idx / D) * D;
    const int row = q0 + r;
    qs[idx] = row < s ? to_f32(qb[row * q_ss + c]) : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DPL];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }

  const int row0 = q0 + warp * kRowsPerWarp;  // this warp's first row
  // causal: key tiles strictly above this query tile's diagonal add
  // nothing and are never loaded
  const int kv_end = causal ? min(s, q0 + kBlockM) : s;
  for (int kv0 = 0; kv0 < kv_end; kv0 += kBlockN) {
    __syncthreads();  // the previous tile is consumed (Q is written)
    for (int idx = tid; idx < kBlockN * D; idx += kWarps * 32) {
      const int j = idx / D, c = idx - (idx / D) * D;
      const int key = kv0 + j;
      const bool ok = key < s;  // keys past the end load as zeros
      ks[j * (D + 1) + c] = ok ? to_f32(kb[key * k_ss + c]) : 0.f;
      vs[j * D + c] = ok ? to_f32(vb[key * v_ss + c]) : 0.f;
    }
    __syncthreads();

    // scores: lane j holds key kv0 + j for each of the warp's rows
    float sc[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) sc[r] = 0.f;
    const float* krow = ks + lane * (D + 1);
    const float* qrows = qs + (warp * kRowsPerWarp) * D;
#pragma unroll 2
    for (int c = 0; c < D; c += 4) {
      const float k0 = krow[c], k1 = krow[c + 1], k2 = krow[c + 2],
                  k3 = krow[c + 3];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(qrows + r * D + c);
        float t = sc[r];
        t = fmaf(qv.x, k0, t);
        t = fmaf(qv.y, k1, t);
        t = fmaf(qv.z, k2, t);
        t = fmaf(qv.w, k3, t);
        sc[r] = t;
      }
    }

    const int key = kv0 + lane;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = row0 + r;
      const bool live = key < s && (!causal || key <= row);
      const float x = live ? sc[r] * scale : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(x));
      const float p = expf(x - m_new);
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + warp_sum(p);
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] *= corr;
      sc[r] = p;
    }

    // P.V: acc[r][i] += sum_j p[r][j] * V[j][lane + 32 i]
#pragma unroll 4
    for (int j = 0; j < kBlockN; ++j) {
      float vv[DPL];
#pragma unroll
      for (int i = 0; i < DPL; ++i) vv[i] = vs[j * D + lane + 32 * i];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float p = __shfl_sync(kFull, sc[r], j);
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[r][i] = fmaf(p, vv[i], acc[r][i]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = row0 + r;
    if (row < s) {
      const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
      for (int i = 0; i < DPL; ++i)
        ob[row * o_ss + lane + 32 * i] = from_f32<T>(acc[r][i] * inv);
      // K1-lse: m and l are warp-uniform after the reductions, so lane 0
      // writes the row's log-sum-exp
      if (lse != nullptr && lane == 0)
        lse[(static_cast<int64_t>(batch) * gridDim.y + head) * s + row] =
            m[r] + logf(fmaxf(l[r], 1e-30f));
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int s, int h, const int64_t* st, int causal, float scale,
           float* lse, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((s + kBlockM - 1) / kBlockM, h, b);
  flash_fwd_kernel<T, D><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), s, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], scale,
      causal, lse);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* o, int b,
               int s, int h, int d, const int64_t* st, int causal,
               float scale, float* lse, cudaStream_t stream) {
  switch (d) {
    case 32: return launch<T, 32>(q, k, v, o, b, s, h, st, causal, scale, lse, stream);
    case 64: return launch<T, 64>(q, k, v, o, b, s, h, st, causal, scale, lse, stream);
    case 128: return launch<T, 128>(q, k, v, o, b, s, h, st, causal, scale, lse, stream);
    case 256: return launch<T, 256>(q, k, v, o, b, s, h, st, causal, scale, lse, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int forward(const void* q, const void* k, const void* v, void* o, int dtype,
            int b, int s, int h, int d, const int64_t* strides, int causal,
            float scale, float* lse, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b <= 0 || s <= 0 || h <= 0) return 0;  // nothing to compute
  if (h > 65535 || b > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, o, b, s, h, d, strides, causal, scale,
                             lse, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, o, b, s, h, d, strides, causal,
                                     scale, lse, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. strides: 12 element strides, in the
// order (batch, seq, head) for q, k, v, o. Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int dmt_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, void* o, int dtype,
                                       int b, int s, int h, int d,
                                       const int64_t* strides, int causal,
                                       float scale, void* stream) {
  return forward(q, k, v, o, dtype, b, s, h, d, strides, causal, scale,
                 nullptr, stream);
}

// K1-lse: the same forward, also writing lse [b, h, s] float32
// (contiguous) for the backward kernels.
extern "C" int dmt_flash_attention_fwd_lse(const void* q, const void* k,
                                           const void* v, void* o,
                                           float* lse, int dtype, int b,
                                           int s, int h, int d,
                                           const int64_t* strides,
                                           int causal, float scale,
                                           void* stream) {
  return forward(q, k, v, o, dtype, b, s, h, d, strides, causal, scale, lse,
                 stream);
}
