// K2, K3, K4: flash-attention backward for Hopper (sm_90a), plain CUDA C++.
//
// Replaces, in distributedmnist_tpu/ops/pallas_attention.py (the custom
// VJP's _backward):
//   K2 _bwd_dq_kernel    -> bwd_dq_kernel    (entry dmt_flash_attention_bwd_dq)
//   K3 _bwd_dkv_kernel   -> bwd_dkv_kernel   (entry dmt_flash_attention_bwd_dkv)
//   K4 _bwd_fused_kernel -> bwd_fused_kernel (entry dmt_flash_attention_bwd_fused)
//
// The FlashAttention-2 backward from the forward's per-row log-sum-exp
// (K1-lse, csrc/flash_attention_fwd.cu): for each (query i, key j) pair
// at or below the causal diagonal
//   p  = exp(q_i.k_j * scale - lse_i)          (selection-masked to 0)
//   ds = p * (do_i.v_j - delta_i),  delta_i = rowsum(do_i * o_i)
//   dq_i += scale * ds * k_j,  dk_j += scale * ds * q_i,  dv_j += p * do_i
// delta is recomputed in each kernel from the o residual, as the TPU
// kernels do: no separate launch and no HBM array. The [s, s] score and
// probability matrices never reach device memory.
//
// What bounds it on this card: at the training shape (seq 1024, 16
// heads of 128, batch 16) a layer's backward recomputes the scores and
// does four more score-sized products, ~0.17 TFLOP in all for ~0.2 GB
// of q/k/v/o/do/dq/dk/dv traffic, so it is bound by arithmetic. These
// first kernels use the CUDA cores in float32 (no tensor cores yet), so
// the float32 CUDA-core rate is their ceiling; wgmma/TMA are later work.
// Like the TPU kernels, each kernel reads every operand tile once per
// visit, keeps its accumulators on chip, and skips tiles wholly above
// the causal diagonal.
//
// Translation from the TPU: there, dq and dk/dv accumulate in VMEM
// scratch across a sequential ("arbitrary") grid axis. Here a thread
// block owns its output tile and loops over the other axis itself:
//   K2: one block per (64-query tile, head, batch); the loop walks the
//       32-key tiles up to the diagonal; dq stays in registers.
//   K3: one block per (64-key tile, head, batch); the loop walks the
//       32-query tiles from the diagonal on; dk and dv stay in
//       registers while q, do, o stream past. No atomics anywhere, so
//       every result is deterministic.
//   K4: the whole (padded) sequence fits one 64 x 64 tile: one block per
//       (head, batch) computes p and do.v^T once and feeds dq, dk and dv
//       from them (5 score-sized products instead of K2+K3's 7).
// Rounding: p and ds stay float32 for every product. The TPU kernels
// round them to the input dtype first (bf16 on the bf16 path), so in
// bf16 these kernels sit a little closer to the float32 oracle.
//
// Layout: q, k, v, o, do and dq, dk, dv are [batch, seq, heads,
// head_dim], read and written through element strides (the model hands
// strided qkv[:, :, i] views); the last dimension must be contiguous.
// lse is float32 [batch, heads, seq], contiguous. Warps own 8 rows each
// and lanes own either one key/query of a 32-wide streamed tile (score
// phase) or the column slice {lane + 32 i} (accumulation phase), the
// same scheme as K1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTileRows = 64;    // rows a block owns: queries (K2), keys (K3)
constexpr int kTileStream = 32;  // streamed tile: one key (K2) / query (K3) per lane
constexpr int kRowsPerWarp = kTileRows / kWarps;
constexpr int kFusedSeq = 64;    // K4: the whole padded sequence
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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// Element strides (batch, seq, head) of the eight [b, s, h, d] tensors,
// in the order q, k, v, o, do, dq, dk, dv.
struct Strides {
  int64_t v[24];
};
enum { kQ = 0, kK = 3, kV = 6, kO = 9, kDO = 12, kDQ = 15, kDK = 18, kDV = 21 };

template <typename P>
__device__ __forceinline__ P* head_base(P* x, const Strides& st, int which,
                                        int batch, int head) {
  return x + batch * st.v[which] + head * st.v[which + 2];
}

// Copy rows [row0, row0 + rows) of one head into smem rows of width
// `ld` floats (zeros past the sequence end).
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src,
                                          int64_t row_stride, int row0,
                                          int rows, int s) {
  for (int idx = threadIdx.x; idx < rows * D; idx += kThreads) {
    const int r = idx / D, c = idx - (idx / D) * D;
    const int row = row0 + r;
    dst[r * ld + c] = row < s ? to_f32(src[row * row_stride + c]) : 0.f;
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  // q and do tiles [64][D] (broadcast reads), k and v tiles [32][D + 1]
  // (the +1 pad makes lane j's row walk conflict-free)
  return sizeof(float) * (2 * kTileRows * D + 2 * kTileStream * (D + 1));
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  // k and v tiles [64][D], q and do tiles [32][D + 1], lse and delta [32]
  return sizeof(float) *
         (2 * kTileRows * D + 2 * kTileStream * (D + 1) + 2 * kTileStream);
}

template <int D>
constexpr size_t fused_smem_bytes() {
  // q, k, v, do [64][D + 1]; p and ds [64][65]; lse [64]
  return sizeof(float) * (4 * kFusedSeq * (D + 1) +
                          2 * kFusedSeq * (kFusedSeq + 1) + kFusedSeq);
}

// ---------------------------------------------------------------- K2: dq
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ o,
                  const T* __restrict__ dout, const float* __restrict__ lse,
                  T* __restrict__ dq, int s, Strides st, float scale,
                  int causal) {
  constexpr int DPL = D / 32;
  extern __shared__ float smem[];
  float* qs = smem;                          // [64][D]
  float* dos = qs + kTileRows * D;           // [64][D]
  float* ks = dos + kTileRows * D;           // [32][D + 1]
  float* vs = ks + kTileStream * (D + 1);    // [32][D + 1]

  const int q0 = blockIdx.x * kTileRows;
  const int head = blockIdx.y, batch = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* qb = head_base(q, st, kQ, batch, head);
  const T* kb = head_base(k, st, kK, batch, head);
  const T* vb = head_base(v, st, kV, batch, head);
  const T* ob = head_base(o, st, kO, batch, head);
  const T* dob = head_base(dout, st, kDO, batch, head);
  T* dqb = head_base(dq, st, kDQ, batch, head);
  const float* lseb = lse + (static_cast<int64_t>(batch) * gridDim.y + head) * s;

  load_rows<T, D>(qs, D, qb, st.v[kQ + 1], q0, kTileRows, s);
  load_rows<T, D>(dos, D, dob, st.v[kDO + 1], q0, kTileRows, s);
  __syncthreads();

  const int row0 = q0 + warp * kRowsPerWarp;
  float delta[kRowsPerWarp], lse_r[kRowsPerWarp], acc[kRowsPerWarp][DPL];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = row0 + r;
    float part = 0.f;
    if (row < s) {
#pragma unroll
      for (int i = 0; i < DPL; ++i)
        part += dos[(row - q0) * D + lane + 32 * i] *
                to_f32(ob[row * st.v[kO + 1] + lane + 32 * i]);
    }
    delta[r] = warp_sum(part);
    lse_r[r] = row < s ? lseb[row] : 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }

  const int kv_end = causal ? min(s, q0 + kTileRows) : s;
  for (int kv0 = 0; kv0 < kv_end; kv0 += kTileStream) {
    __syncthreads();  // the previous k/v tile is consumed
    load_rows<T, D>(ks, D + 1, kb, st.v[kK + 1], kv0, kTileStream, s);
    load_rows<T, D>(vs, D + 1, vb, st.v[kV + 1], kv0, kTileStream, s);
    __syncthreads();

    // lane j: score and do.v^T of key kv0 + j against the warp's rows
    float sc[kRowsPerWarp], dp[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) sc[r] = dp[r] = 0.f;
    const float* krow = ks + lane * (D + 1);
    const float* vrow = vs + lane * (D + 1);
    const float* qrows = qs + (warp * kRowsPerWarp) * D;
    const float* dorows = dos + (warp * kRowsPerWarp) * D;
#pragma unroll 2
    for (int c = 0; c < D; c += 4) {
      const float k0 = krow[c], k1 = krow[c + 1], k2 = krow[c + 2],
                  k3 = krow[c + 3];
      const float v0 = vrow[c], v1 = vrow[c + 1], v2 = vrow[c + 2],
                  v3 = vrow[c + 3];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(qrows + r * D + c);
        const float4 dv = *reinterpret_cast<const float4*>(dorows + r * D + c);
        sc[r] = fmaf(qv.w, k3, fmaf(qv.z, k2, fmaf(qv.y, k1,
                                                   fmaf(qv.x, k0, sc[r]))));
        dp[r] = fmaf(dv.w, v3, fmaf(dv.z, v2, fmaf(dv.y, v1,
                                                   fmaf(dv.x, v0, dp[r]))));
      }
    }
    const int key = kv0 + lane;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = row0 + r;
      const bool live = row < s && key < s && (!causal || key <= row);
      // selection, not arithmetic: a padded row's lse is not a number
      // to trust, so its p is 0 without ever evaluating exp on it
      const float p = live ? expf(sc[r] * scale - lse_r[r]) : 0.f;
      sc[r] = p * (dp[r] - delta[r]);  // ds
    }

    // dq[r][lane + 32 i] += sum_j ds[r][j] * K[j][lane + 32 i]
#pragma unroll 4
    for (int j = 0; j < kTileStream; ++j) {
      float kk[DPL];
#pragma unroll
      for (int i = 0; i < DPL; ++i) kk[i] = ks[j * (D + 1) + lane + 32 * i];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float ds = __shfl_sync(kFull, sc[r], j);
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[r][i] = fmaf(ds, kk[i], acc[r][i]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = row0 + r;
    if (row < s) {
#pragma unroll
      for (int i = 0; i < DPL; ++i)
        dqb[row * st.v[kDQ + 1] + lane + 32 * i] =
            from_f32<T>(acc[r][i] * scale);
    }
  }
}

// ------------------------------------------------------------ K3: dk, dv
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ o,
                   const T* __restrict__ dout, const float* __restrict__ lse,
                   T* __restrict__ dk, T* __restrict__ dv, int s, Strides st,
                   float scale, int causal) {
  constexpr int DPL = D / 32;
  extern __shared__ float smem[];
  float* ks = smem;                          // [64][D]
  float* vs = ks + kTileRows * D;            // [64][D]
  float* qs = vs + kTileRows * D;            // [32][D + 1]
  float* dos = qs + kTileStream * (D + 1);   // [32][D + 1]
  float* lse_s = dos + kTileStream * (D + 1);  // [32]
  float* delta_s = lse_s + kTileStream;        // [32]

  const int k0 = blockIdx.x * kTileRows;
  const int head = blockIdx.y, batch = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* qb = head_base(q, st, kQ, batch, head);
  const T* kb = head_base(k, st, kK, batch, head);
  const T* vb = head_base(v, st, kV, batch, head);
  const T* ob = head_base(o, st, kO, batch, head);
  const T* dob = head_base(dout, st, kDO, batch, head);
  T* dkb = head_base(dk, st, kDK, batch, head);
  T* dvb = head_base(dv, st, kDV, batch, head);
  const float* lseb = lse + (static_cast<int64_t>(batch) * gridDim.y + head) * s;

  load_rows<T, D>(ks, D, kb, st.v[kK + 1], k0, kTileRows, s);
  load_rows<T, D>(vs, D, vb, st.v[kV + 1], k0, kTileRows, s);

  float dk_acc[kRowsPerWarp][DPL], dv_acc[kRowsPerWarp][DPL];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int i = 0; i < DPL; ++i) dk_acc[r][i] = dv_acc[r][i] = 0.f;

  const int key0 = k0 + warp * kRowsPerWarp;  // this warp's first key
  // causal: query tiles wholly before this key tile see none of it
  const int q_begin = causal ? (k0 / kTileStream) * kTileStream : 0;
  for (int q0 = q_begin; q0 < s; q0 += kTileStream) {
    __syncthreads();  // the previous q/do tile is consumed (k/v written)
    load_rows<T, D>(qs, D + 1, qb, st.v[kQ + 1], q0, kTileStream, s);
    load_rows<T, D>(dos, D + 1, dob, st.v[kDO + 1], q0, kTileStream, s);
    __syncthreads();
    // delta and lse of the tile's 32 queries, 4 per warp
#pragma unroll
    for (int t = 0; t < kTileStream / kWarps; ++t) {
      const int i = warp * (kTileStream / kWarps) + t;
      const int qi = q0 + i;
      float part = 0.f;
      if (qi < s) {
#pragma unroll
        for (int c = 0; c < DPL; ++c)
          part += dos[i * (D + 1) + lane + 32 * c] *
                  to_f32(ob[qi * st.v[kO + 1] + lane + 32 * c]);
      }
      part = warp_sum(part);
      if (lane == 0) {
        delta_s[i] = part;
        lse_s[i] = qi < s ? lseb[qi] : 0.f;
      }
    }
    __syncthreads();

    // lane i: score and v.do^T of query q0 + i against the warp's keys
    float sc[kRowsPerWarp], dp[kRowsPerWarp], pr[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) sc[r] = dp[r] = 0.f;
    const float* qrow = qs + lane * (D + 1);
    const float* dorow = dos + lane * (D + 1);
    const float* krows = ks + (warp * kRowsPerWarp) * D;
    const float* vrows = vs + (warp * kRowsPerWarp) * D;
#pragma unroll 2
    for (int c = 0; c < D; c += 4) {
      const float q0v = qrow[c], q1v = qrow[c + 1], q2v = qrow[c + 2],
                  q3v = qrow[c + 3];
      const float d0 = dorow[c], d1 = dorow[c + 1], d2 = dorow[c + 2],
                  d3 = dorow[c + 3];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 kv = *reinterpret_cast<const float4*>(krows + r * D + c);
        const float4 vv = *reinterpret_cast<const float4*>(vrows + r * D + c);
        sc[r] = fmaf(kv.w, q3v, fmaf(kv.z, q2v, fmaf(kv.y, q1v,
                                                     fmaf(kv.x, q0v, sc[r]))));
        dp[r] = fmaf(vv.w, d3, fmaf(vv.z, d2, fmaf(vv.y, d1,
                                                   fmaf(vv.x, d0, dp[r]))));
      }
    }
    const int qi = q0 + lane;
    const float lse_i = lse_s[lane], delta_i = delta_s[lane];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int key = key0 + r;
      const bool live = qi < s && key < s && (!causal || key <= qi);
      const float p = live ? expf(sc[r] * scale - lse_i) : 0.f;
      pr[r] = p;
      sc[r] = p * (dp[r] - delta_i);  // ds
    }

    // dv[r][c] += sum_i p[r][i] * do[i][c]; dk[r][c] += sum_i ds[r][i] * q[i][c]
#pragma unroll 4
    for (int i = 0; i < kTileStream; ++i) {
      float qq[DPL], dd[DPL];
#pragma unroll
      for (int c = 0; c < DPL; ++c) {
        qq[c] = qs[i * (D + 1) + lane + 32 * c];
        dd[c] = dos[i * (D + 1) + lane + 32 * c];
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float p = __shfl_sync(kFull, pr[r], i);
        const float ds = __shfl_sync(kFull, sc[r], i);
#pragma unroll
        for (int c = 0; c < DPL; ++c) {
          dv_acc[r][c] = fmaf(p, dd[c], dv_acc[r][c]);
          dk_acc[r][c] = fmaf(ds, qq[c], dk_acc[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int key = key0 + r;
    if (key < s) {
#pragma unroll
      for (int c = 0; c < DPL; ++c) {
        dkb[key * st.v[kDK + 1] + lane + 32 * c] =
            from_f32<T>(dk_acc[r][c] * scale);
        dvb[key * st.v[kDV + 1] + lane + 32 * c] = from_f32<T>(dv_acc[r][c]);
      }
    }
  }
}

// ------------------------------------------------- K4: dq, dk, dv fused
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    bwd_fused_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ o,
                     const T* __restrict__ dout,
                     const float* __restrict__ lse, T* __restrict__ dq,
                     T* __restrict__ dk, T* __restrict__ dv, int s,
                     Strides st, float scale, int causal) {
  constexpr int DPL = D / 32;
  constexpr int LD = D + 1;
  constexpr int LP = kFusedSeq + 1;
  extern __shared__ float smem[];
  float* qs = smem;                     // [64][D + 1]
  float* ks = qs + kFusedSeq * LD;      // [64][D + 1]
  float* vs = ks + kFusedSeq * LD;      // [64][D + 1]
  float* dos = vs + kFusedSeq * LD;     // [64][D + 1]
  float* ps = dos + kFusedSeq * LD;     // [64][65]  p
  float* dss = ps + kFusedSeq * LP;     // [64][65]  ds
  float* lse_s = dss + kFusedSeq * LP;  // [64]

  const int head = blockIdx.y, batch = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* ob = head_base(o, st, kO, batch, head);
  const float* lseb = lse + (static_cast<int64_t>(batch) * gridDim.y + head) * s;

  load_rows<T, D>(qs, LD, head_base(q, st, kQ, batch, head), st.v[kQ + 1], 0,
                  kFusedSeq, s);
  load_rows<T, D>(ks, LD, head_base(k, st, kK, batch, head), st.v[kK + 1], 0,
                  kFusedSeq, s);
  load_rows<T, D>(vs, LD, head_base(v, st, kV, batch, head), st.v[kV + 1], 0,
                  kFusedSeq, s);
  load_rows<T, D>(dos, LD, head_base(dout, st, kDO, batch, head),
                  st.v[kDO + 1], 0, kFusedSeq, s);
  for (int i = threadIdx.x; i < kFusedSeq; i += kThreads)
    lse_s[i] = i < s ? lseb[i] : 0.f;
  __syncthreads();

  // p and ds once: warp rows r, lane keys {lane, lane + 32}
  const int row0 = warp * kRowsPerWarp;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = row0 + r;
    float part = 0.f;
    if (row < s) {
#pragma unroll
      for (int i = 0; i < DPL; ++i)
        part += dos[row * LD + lane + 32 * i] *
                to_f32(ob[row * st.v[kO + 1] + lane + 32 * i]);
    }
    const float delta = warp_sum(part);
    float s0 = 0.f, s1 = 0.f, dp0 = 0.f, dp1 = 0.f;
    const float* qr = qs + row * LD;
    const float* dr = dos + row * LD;
    const float* k0r = ks + lane * LD;
    const float* k1r = ks + (lane + 32) * LD;
    const float* v0r = vs + lane * LD;
    const float* v1r = vs + (lane + 32) * LD;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      const float qc = qr[c], dc = dr[c];
      s0 = fmaf(qc, k0r[c], s0);
      s1 = fmaf(qc, k1r[c], s1);
      dp0 = fmaf(dc, v0r[c], dp0);
      dp1 = fmaf(dc, v1r[c], dp1);
    }
    const float lse_r = lse_s[row];
    const bool live0 = row < s && lane < s && (!causal || lane <= row);
    const bool live1 =
        row < s && lane + 32 < s && (!causal || lane + 32 <= row);
    const float p0 = live0 ? expf(s0 * scale - lse_r) : 0.f;
    const float p1 = live1 ? expf(s1 * scale - lse_r) : 0.f;
    ps[row * LP + lane] = p0;
    ps[row * LP + lane + 32] = p1;
    dss[row * LP + lane] = p0 * (dp0 - delta);
    dss[row * LP + lane + 32] = p1 * (dp1 - delta);
  }
  __syncthreads();

  // dq rows (warp rows r), dk and dv rows (warp keys r); lane columns
  const int n = min(s, kFusedSeq);
  T* dqb = head_base(dq, st, kDQ, batch, head);
  T* dkb = head_base(dk, st, kDK, batch, head);
  T* dvb = head_base(dv, st, kDV, batch, head);
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = row0 + r;
    if (row >= s) continue;  // warp-uniform
    float aq[DPL], ak[DPL], av[DPL];
#pragma unroll
    for (int i = 0; i < DPL; ++i) aq[i] = ak[i] = av[i] = 0.f;
    for (int j = 0; j < n; ++j) {
      const float ds_rj = dss[row * LP + j];  // dq: row's ds over keys j
      const float ds_jr = dss[j * LP + row];  // dk: key `row` over queries j
      const float p_jr = ps[j * LP + row];
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int c = lane + 32 * i;
        aq[i] = fmaf(ds_rj, ks[j * LD + c], aq[i]);
        ak[i] = fmaf(ds_jr, qs[j * LD + c], ak[i]);
        av[i] = fmaf(p_jr, dos[j * LD + c], av[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int c = lane + 32 * i;
      dqb[row * st.v[kDQ + 1] + c] = from_f32<T>(aq[i] * scale);
      dkb[row * st.v[kDK + 1] + c] = from_f32<T>(ak[i] * scale);
      dvb[row * st.v[kDV + 1] + c] = from_f32<T>(av[i]);
    }
  }
}

// ------------------------------------------------------------ launchers
enum Which { kDq = 0, kDkv = 1, kFused = 2 };

template <typename T, int D>
int launch(Which which, const void* q, const void* k, const void* v,
           const void* o, const void* dout, const float* lse, void* dq,
           void* dk, void* dv, int b, int s, int h, const Strides& st,
           int causal, float scale, cudaStream_t stream) {
  const T* Q = static_cast<const T*>(q);
  const T* K = static_cast<const T*>(k);
  const T* V = static_cast<const T*>(v);
  const T* O = static_cast<const T*>(o);
  const T* DO = static_cast<const T*>(dout);
  cudaError_t err;
  if (which == kDq) {
    const size_t smem = dq_smem_bytes<D>();
    err = cudaFuncSetAttribute(bwd_dq_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid((s + kTileRows - 1) / kTileRows, h, b);
    bwd_dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(
        Q, K, V, O, DO, lse, static_cast<T*>(dq), s, st, scale, causal);
  } else if (which == kDkv) {
    const size_t smem = dkv_smem_bytes<D>();
    err = cudaFuncSetAttribute(bwd_dkv_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid((s + kTileRows - 1) / kTileRows, h, b);
    bwd_dkv_kernel<T, D><<<grid, kThreads, smem, stream>>>(
        Q, K, V, O, DO, lse, static_cast<T*>(dk), static_cast<T*>(dv), s, st,
        scale, causal);
  } else {
    if (s > kFusedSeq) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = fused_smem_bytes<D>();
    err = cudaFuncSetAttribute(bwd_fused_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid(1, h, b);
    bwd_fused_kernel<T, D><<<grid, kThreads, smem, stream>>>(
        Q, K, V, O, DO, lse, static_cast<T*>(dq), static_cast<T*>(dk),
        static_cast<T*>(dv), s, st, scale, causal);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(Which which, const void* q, const void* k, const void* v,
               const void* o, const void* dout, const float* lse, void* dq,
               void* dk, void* dv, int b, int s, int h, int d,
               const Strides& st, int causal, float scale,
               cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<T, 32>(which, q, k, v, o, dout, lse, dq, dk, dv, b, s, h,
                           st, causal, scale, stream);
    case 64:
      return launch<T, 64>(which, q, k, v, o, dout, lse, dq, dk, dv, b, s, h,
                           st, causal, scale, stream);
    case 128:
      return launch<T, 128>(which, q, k, v, o, dout, lse, dq, dk, dv, b, s,
                            h, st, causal, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int backward(Which which, const void* q, const void* k, const void* v,
             const void* o, const void* dout, const float* lse, void* dq,
             void* dk, void* dv, int dtype, int b, int s, int h, int d,
             const int64_t* strides, int causal, float scale, void* stream) {
  if (b <= 0 || s <= 0 || h <= 0) return 0;  // nothing to compute
  if (h > 65535 || b > 65535) return static_cast<int>(cudaErrorInvalidValue);
  Strides st;
  for (int i = 0; i < 24; ++i) st.v[i] = strides[i];
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(which, q, k, v, o, dout, lse, dq, dk, dv, b, s,
                             h, d, st, causal, scale, cs);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(which, q, k, v, o, dout, lse, dq, dk, dv,
                                     b, s, h, d, st, causal, scale, cs);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Common signature. dtype: 0 = float32, 1 = bfloat16 (every [b, s, h, d]
// tensor has it). strides: 24 element strides, (batch, seq, head) of q,
// k, v, o, do, dq, dk, dv in that order. Pointers a kernel does not
// write (dk, dv for K2; dq for K3) may be null. Returns
// cudaGetLastError() after the launch (0 on success).
#define DMT_BWD_ARGS                                                       \
  const void *q, const void *k, const void *v, const void *o,             \
      const void *dout, const float *lse, void *dq, void *dk, void *dv,   \
      int dtype, int b, int s, int h, int d, const int64_t *strides,      \
      int causal, float scale, void *stream
#define DMT_BWD_PASS \
  q, k, v, o, dout, lse, dq, dk, dv, dtype, b, s, h, d, strides, causal, scale, stream

// K2: dq only.
extern "C" int dmt_flash_attention_bwd_dq(DMT_BWD_ARGS) {
  return backward(kDq, DMT_BWD_PASS);
}

// K3: dk and dv.
extern "C" int dmt_flash_attention_bwd_dkv(DMT_BWD_ARGS) {
  return backward(kDkv, DMT_BWD_PASS);
}

// K4: dq, dk and dv in one visit; s must be at most 64.
extern "C" int dmt_flash_attention_bwd_fused(DMT_BWD_ARGS) {
  return backward(kFused, DMT_BWD_PASS);
}
