// K2, K3, K4: flash-attention backward for Hopper (sm_90a), CUDA C++.
//
// Replaces, in distributedmnist_tpu/ops/pallas_attention.py (the custom
// VJP's _backward):
//   K2 _bwd_dq_kernel    -> bwd_dq_tc_kernel (bf16), bwd_dq_kernel (f32)
//                           (entry dmt_flash_attention_bwd_dq)
//   K3 _bwd_dkv_kernel   -> bwd_dkv_tc_kernel (bf16), bwd_dkv_kernel (f32)
//                           (entry dmt_flash_attention_bwd_dkv)
//   K4 _bwd_fused_kernel -> bwd_fused_tc_kernel (bf16), bwd_fused_kernel
//                           (f32) (entry dmt_flash_attention_bwd_fused)
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
// What bounds it on this card, at the main paths' shapes (each input
// read once and each output written once, 3.35 TB/s; 2 d FLOP per causal
// (query, key) pair per score-sized product, 989 TFLOP/s bf16):
//   K3 [16, 1024, 16, 128]: 0.47 GB (0.141 ms); 4 products, 137 GFLOP
//       (0.139 ms).
//   K2 the same shape: 0.40 GB (0.121 ms); 3 products, 103 GFLOP
//       (0.104 ms).
//   K4 [64, 64, 16, 128] (the seq-64 run): 0.13 GB (0.040 ms); 5
//       products, 2.7 GFLOP (0.003 ms).
// In K2 and K3 bytes and operations about meet, so no CUDA-core kernel
// can come near either bound (the float32 CUDA-core peak is 15x below
// the bf16 tensor-core peak): the tensor cores are the lever. K4 is
// bytes-bound by far: what counts there is to read each operand once and
// keep every intermediate on chip, with its products off the CUDA
// cores. Like the TPU kernels, each kernel reads every operand tile once
// per visit, keeps its accumulators on chip, and skips tiles wholly
// above the causal diagonal.
//
// Translation from the TPU: there, dq and dk/dv accumulate in VMEM
// scratch across a sequential ("arbitrary") grid axis. Here a thread
// block owns its output tile and loops over the other axis itself, so
// nothing is reduced across blocks: no atomics, and every result is
// deterministic.
//   K2, bfloat16 (bwd_dq_tc_kernel, on the tensor cores): one block of
//       two warpgroups per (128-query tile, head, batch), 64 queries a
//       warpgroup, the last query tile (the heaviest under the causal
//       mask) launched first. q and do are loaded once (K-major), lse
//       with them, and delta = rowsum(do * o) is computed once a block;
//       64-key tiles of k and v stream through a 2-stage cp.async ring
//       from key 0 up to the tile that holds the diagonal, each read by
//       both warpgroups. Per tile: s = q.k^T and dp = do.v^T (SS wgmma,
//       both K-major); p = exp(s scale - lse), zeroed by selection; ds
//       = p * (dp - delta), rounded to bf16 as the TPU kernel rounds it
//       to k's dtype, is the A operand of dq += ds.k (RS wgmma, k
//       MN-major). dq stays in f32 registers. 181 registers, ~130 KB of
//       shared memory, 1 block of 8 warps per SM; 13% faster at the
//       training shape than one warpgroup per 64 queries (2 blocks of 4
//       warps), which streams every k/v tile twice as often.
//   K3, bfloat16 (bwd_dkv_tc_kernel, on the tensor cores): one
//       warpgroup per (64-key tile, head, batch), key tile 0 (the
//       heaviest under the causal mask) launched first. k and v stay in
//       shared memory and dk, dv (64 x d each) in f32 registers while
//       64-query tiles of q and do stream through a 2-stage cp.async
//       ring, from the first tile that meets the diagonal. Per tile:
//       delta = rowsum(do * o) from o (its loads issued before the
//       wait for the q/do tile); s^T = k.q^T and dp^T = v.do^T (SS
//       wgmma, both K-major); p^T = exp(s^T scale - lse), zeroed by
//       selection; ds^T = p^T * (dp^T - delta); dv += bf16(p^T).do and
//       dk += bf16(ds^T).q (RS wgmma, do and q MN-major). p and ds are
//       rounded to bf16 before those products, as the TPU kernel rounds
//       them to the input dtype. 255 registers a thread without spills
//       (delta is done before the score products, whose accumulators
//       it would otherwise share the register file with), 2 blocks of
//       4 warps per SM (~100 KB of shared memory each).
//   K4, bfloat16 (bwd_fused_tc_kernel, on the tensor cores): the whole
//       padded sequence is one 64-row tile. One warpgroup per (head,
//       batch) loads q, k, v and do once, computes s = q.k^T and dp =
//       do.v^T once (SS) and feeds all three gradients from them: 5
//       products instead of K2 + K3's 7. dq = bf16(ds).k comes straight
//       from registers (RS, k MN-major). dv = bf16(p)^T.do and dk =
//       bf16(ds)^T.q need the transpose of a register fragment as their
//       A operand: p and ds are stored transposed into two 64 x 64
//       swizzled tiles, made visible to the tensor cores' reads
//       (fence.proxy.async, barrier), and read K-major beside do and q
//       as MN-major B (SS). ~82 KB of shared memory, 2 blocks per SM.
//   float32 (bwd_dq_kernel, bwd_dkv_kernel, bwd_fused_kernel, CUDA
//       cores: tensor cores would mean TF32 and miss the float32
//       agreement at 1e-4): K2 one 8-warp block per 64-query tile walking
//       32-key tiles up to the diagonal; K3 one per 64-key tile walking
//       32-query tiles from the diagonal on; K4 one per (head, batch),
//       p and ds once for dq, dk and dv. p and ds stay in float32.
//
// Layout: q, k, v, o, do and dq, dk, dv are [batch, seq, heads,
// head_dim], read and written through element strides (the model hands
// strided qkv[:, :, i] views); the last dimension must be contiguous.
// lse is float32 [batch, heads, seq], contiguous. In the CUDA-core
// kernels warps own 8 rows each and lanes own either one key/query of a
// 32-wide streamed tile (score phase) or the column slice {lane + 32 i}
// (accumulation phase), the same scheme as the float32 K1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

namespace wg = dmt_wgmma;
using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTileRows = 64;    // rows a block owns: queries (K2), keys (K3)
constexpr int kTileStream = 32;  // streamed tile: one key (K2) / query (K3) per lane
constexpr int kRowsPerWarp = kTileRows / kWarps;
constexpr int kFusedSeq = 64;    // K4: the whole padded sequence
constexpr unsigned kFull = 0xffffffffu;

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
template <int D>
__device__ __forceinline__ void load_rows(float* dst, int ld,
                                          const float* src,
                                          int64_t row_stride, int row0,
                                          int rows, int s) {
  for (int idx = threadIdx.x; idx < rows * D; idx += kThreads) {
    const int r = idx / D, c = idx - (idx / D) * D;
    const int row = row0 + r;
    dst[r * ld + c] = row < s ? src[row * row_stride + c] : 0.f;
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

// ------------------------------------------------------ K2, float32: dq
template <int D>
__global__ void __launch_bounds__(kThreads)
    bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ o,
                  const float* __restrict__ dout,
                  const float* __restrict__ lse, float* __restrict__ dq,
                  int s, Strides st, float scale, int causal) {
  constexpr int DPL = D / 32;
  extern __shared__ float smem[];
  float* qs = smem;                          // [64][D]
  float* dos = qs + kTileRows * D;           // [64][D]
  float* ks = dos + kTileRows * D;           // [32][D + 1]
  float* vs = ks + kTileStream * (D + 1);    // [32][D + 1]

  const int q0 = blockIdx.x * kTileRows;
  const int head = blockIdx.y, batch = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* qb = head_base(q, st, kQ, batch, head);
  const float* kb = head_base(k, st, kK, batch, head);
  const float* vb = head_base(v, st, kV, batch, head);
  const float* ob = head_base(o, st, kO, batch, head);
  const float* dob = head_base(dout, st, kDO, batch, head);
  float* dqb = head_base(dq, st, kDQ, batch, head);
  const float* lseb = lse + (static_cast<int64_t>(batch) * gridDim.y + head) * s;

  load_rows<D>(qs, D, qb, st.v[kQ + 1], q0, kTileRows, s);
  load_rows<D>(dos, D, dob, st.v[kDO + 1], q0, kTileRows, s);
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
                ob[row * st.v[kO + 1] + lane + 32 * i];
    }
    delta[r] = warp_sum(part);
    lse_r[r] = row < s ? lseb[row] : 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }

  const int kv_end = causal ? min(s, q0 + kTileRows) : s;
  for (int kv0 = 0; kv0 < kv_end; kv0 += kTileStream) {
    __syncthreads();  // the previous k/v tile is consumed
    load_rows<D>(ks, D + 1, kb, st.v[kK + 1], kv0, kTileStream, s);
    load_rows<D>(vs, D + 1, vb, st.v[kV + 1], kv0, kTileStream, s);
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
        dqb[row * st.v[kDQ + 1] + lane + 32 * i] = acc[r][i] * scale;
    }
  }
}

// ------------------------------------------------ K3, float32: dk, dv
template <int D>
__global__ void __launch_bounds__(kThreads)
    bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ o,
                   const float* __restrict__ dout,
                   const float* __restrict__ lse, float* __restrict__ dk,
                   float* __restrict__ dv, int s, Strides st, float scale,
                   int causal) {
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
  const float* qb = head_base(q, st, kQ, batch, head);
  const float* kb = head_base(k, st, kK, batch, head);
  const float* vb = head_base(v, st, kV, batch, head);
  const float* ob = head_base(o, st, kO, batch, head);
  const float* dob = head_base(dout, st, kDO, batch, head);
  float* dkb = head_base(dk, st, kDK, batch, head);
  float* dvb = head_base(dv, st, kDV, batch, head);
  const float* lseb = lse + (static_cast<int64_t>(batch) * gridDim.y + head) * s;

  load_rows<D>(ks, D, kb, st.v[kK + 1], k0, kTileRows, s);
  load_rows<D>(vs, D, vb, st.v[kV + 1], k0, kTileRows, s);

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
    load_rows<D>(qs, D + 1, qb, st.v[kQ + 1], q0, kTileStream, s);
    load_rows<D>(dos, D + 1, dob, st.v[kDO + 1], q0, kTileStream, s);
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
                  ob[qi * st.v[kO + 1] + lane + 32 * c];
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
            dk_acc[r][c] * scale;
        dvb[key * st.v[kDV + 1] + lane + 32 * c] = dv_acc[r][c];
      }
    }
  }
}

// ------------------------------------------ K4, float32: dq, dk, dv fused
template <int D>
__global__ void __launch_bounds__(kThreads)
    bwd_fused_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ o,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse, float* __restrict__ dq,
                     float* __restrict__ dk, float* __restrict__ dv, int s,
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
  const float* ob = head_base(o, st, kO, batch, head);
  const float* lseb = lse + (static_cast<int64_t>(batch) * gridDim.y + head) * s;

  load_rows<D>(qs, LD, head_base(q, st, kQ, batch, head), st.v[kQ + 1], 0,
               kFusedSeq, s);
  load_rows<D>(ks, LD, head_base(k, st, kK, batch, head), st.v[kK + 1], 0,
               kFusedSeq, s);
  load_rows<D>(vs, LD, head_base(v, st, kV, batch, head), st.v[kV + 1], 0,
               kFusedSeq, s);
  load_rows<D>(dos, LD, head_base(dout, st, kDO, batch, head),
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
                ob[row * st.v[kO + 1] + lane + 32 * i];
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
  float* dqb = head_base(dq, st, kDQ, batch, head);
  float* dkb = head_base(dk, st, kDK, batch, head);
  float* dvb = head_base(dv, st, kDV, batch, head);
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
      dqb[row * st.v[kDQ + 1] + c] = aq[i] * scale;
      dkb[row * st.v[kDK + 1] + c] = ak[i] * scale;
      dvb[row * st.v[kDV + 1] + c] = av[i];
    }
  }
}

// ------------------------------------------------ bfloat16: tensor cores
constexpr int kTcKeys = 64;     // a key tile: K3's own, K2's streamed
constexpr int kTcQueries = 64;  // K3's streamed query tile
constexpr int kDqQueries = 128;  // K2's query tile: two warpgroups
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint8_t* smem_ptr(uint8_t* smem_raw,
                                             uint32_t addr) {
  return smem_raw + (addr - wg::smem_u32(smem_raw));
}

// delta = rowsum(do * o), two threads a query row, each over half the
// columns [col0, col0 + D/2). First this thread's half row of o, from
// device memory (zeros past the sequence end), loaded before the wait
// for the do tile ...
template <int D>
__device__ __forceinline__ void load_o_half(uint4 (&o_part)[D / 16],
                                            const bf16* ob, int64_t ld,
                                            int row, int col0, int s) {
#pragma unroll
  for (int j = 0; j < D / 16; ++j)
    o_part[j] = row < s ? *reinterpret_cast<const uint4*>(ob + row * ld +
                                                          col0 + 8 * j)
                        : make_uint4(0, 0, 0, 0);
}

// ... then its dot product with row r of the swizzled do tile of R rows,
// summed with the partner thread's half (lane ^ 1).
template <int D>
__device__ __forceinline__ float row_delta(const uint4 (&o_part)[D / 16],
                                           const uint8_t* do_tile, int R,
                                           int r, int col0) {
  float part = 0.f;
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    const uint4 dv4 = *reinterpret_cast<const uint4*>(
        do_tile + wg::tile_offset(r, col0 + 8 * j, R));
    const __nv_bfloat162* o2 =
        reinterpret_cast<const __nv_bfloat162*>(&o_part[j]);
    const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv4);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 of = __bfloat1622float2(o2[e]);
      const float2 df = __bfloat1622float2(d2[e]);
      part = fmaf(of.x, df.x, fmaf(of.y, df.y, part));
    }
  }
  return part + __shfl_xor_sync(kFull, part, 1);
}

// bf16(scale * acc) of an m64 x (padded D) accumulator fragment into rows
// [row0, row0 + 64) of a [s, D] gradient with row stride ld; rows past s
// and columns past D are not written.
template <int D, int N>
__device__ __forceinline__ void store_acc(bf16* dst, int64_t ld,
                                          const float (&acc)[N], int row0,
                                          int s, float scale) {
#pragma unroll
  for (int i = 0; i < N; i += 2) {
    const int row = row0 + wg::frag_row(i), col = wg::frag_col(i);
    if (row < s && col < D)
      *reinterpret_cast<__nv_bfloat162*>(dst + row * ld + col) =
          __floats2bfloat162_rn(acc[i] * scale, acc[i + 1] * scale);
  }
}

// ------------------------------------- K2, bfloat16: dq on tensor cores
template <int D>
constexpr size_t dq_tc_smem_bytes() {
  // q and do tiles, two stages of k and v tiles, lse and delta of the
  // queries, and room to align the base
  return 2 * wg::tile_bytes<kDqQueries, D>() +
         4 * wg::tile_bytes<kTcKeys, D>() + 2 * kDqQueries * 4 + 1024;
}

// Two warpgroups of 64 queries each share every k/v tile. Grid: one
// block per (query tile, head, batch), the query tile slowest; causal
// calls take the last query tile, which walks the most key tiles, first.
template <int D>
__global__ void __launch_bounds__(256, 1)
    bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ o,
                     const bf16* __restrict__ dout,
                     const float* __restrict__ lse, bf16* __restrict__ dq,
                     int s, int h, int n_bh, int n_tiles, Strides st,
                     float scale, int causal) {
  constexpr int BM = kDqQueries, BN = kTcKeys, T = 256;
  constexpr int NACC = wg::padded_cols<D>() / 2;  // dq registers
  constexpr uint32_t kStage = wg::tile_bytes<BN, D>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t qs = (wg::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t dos = qs + wg::tile_bytes<BM, D>();
  const uint32_t ks = dos + wg::tile_bytes<BM, D>();  // stage i: ks + i kStage
  const uint32_t vs = ks + 2 * kStage;                // stage i: vs + i kStage
  float* lse_s =
      reinterpret_cast<float*>(smem_ptr(smem_raw, vs + 2 * kStage));  // [BM]
  float* delta_s = lse_s + BM;                                        // [BM]

  const int tile = blockIdx.x / n_bh;
  const int qt = causal ? n_tiles - 1 - tile : tile;
  const int head = blockIdx.x % n_bh % h, batch = blockIdx.x % n_bh / h;
  const bf16* kb = head_base(k, st, kK, batch, head);
  const bf16* vb = head_base(v, st, kV, batch, head);
  const float* lseb = lse + (static_cast<int64_t>(batch) * h + head) * s;
  const int q0 = qt * BM;
  const int wgi = threadIdx.x >> 7;              // this thread's warpgroup
  const int wg_row0 = q0 + wgi * 64;             // its first query
  const int row_lo = wg_row0 + wg::frag_row(0);  // this thread's queries:
                                                 // row_lo, row_lo + 8
  // causal: key tiles wholly above the diagonal are never loaded
  const int kv_end = causal ? min(s, q0 + BM) : s;
  const int n_kv = (kv_end + BN - 1) / BN;

  wg::load_tile<BM, D, T>(qs, head_base(q, st, kQ, batch, head),
                          st.v[kQ + 1], q0, s);
  wg::load_tile<BM, D, T>(dos, head_base(dout, st, kDO, batch, head),
                          st.v[kDO + 1], q0, s);
  if (threadIdx.x < BM) {
    const int qi = q0 + threadIdx.x;
    wg::cp_async4(wg::smem_u32(lse_s + threadIdx.x), lseb + (qi < s ? qi : 0),
                  qi < s);
  }
  wg::cp_async_commit();
  wg::load_tile<BN, D, T>(ks, kb, st.v[kK + 1], 0, s);
  wg::load_tile<BN, D, T>(vs, vb, st.v[kV + 1], 0, s);
  wg::cp_async_commit();

  {  // delta, once a block: two threads a query
    const int d_row = threadIdx.x >> 1, d_col0 = (threadIdx.x & 1) * (D / 2);
    uint4 o_part[D / 16];
    load_o_half<D>(o_part, head_base(o, st, kO, batch, head), st.v[kO + 1],
                   q0 + d_row, d_col0, s);
    wg::cp_async_wait<1>();  // q, do and lse have landed
    wg::fence_async_smem();
    __syncthreads();
    const float delta =
        row_delta<D>(o_part, smem_ptr(smem_raw, dos), BM, d_row, d_col0);
    if ((threadIdx.x & 1) == 0) delta_s[d_row] = delta;
    __syncthreads();
  }
  const float scale_log2 = scale * kLog2e;
  float lse2[2], dlt[2];  // of this thread's two queries
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse2[r] = lse_s[row_lo - q0 + 8 * r] * kLog2e;
    dlt[r] = delta_s[row_lo - q0 + 8 * r];
  }

  float dq_acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) dq_acc[i] = 0.f;
  for (int t = 0; t < n_kv; ++t) {
    const int kv0 = t * BN;
    if (t + 1 < n_kv) {  // prefetch the next k/v tile into the other stage
      const uint32_t nxt = ((t + 1) & 1) * kStage;
      wg::load_tile<BN, D, T>(ks + nxt, kb, st.v[kK + 1], kv0 + BN, s);
      wg::load_tile<BN, D, T>(vs + nxt, vb, st.v[kV + 1], kv0 + BN, s);
      wg::cp_async_commit();
      wg::cp_async_wait<1>();
    } else {
      wg::cp_async_wait<0>();
    }
    wg::fence_async_smem();
    __syncthreads();
    const uint32_t kst = ks + (t & 1) * kStage, vst = vs + (t & 1) * kStage;
    // causal: a key tile wholly above this warpgroup's queries adds nothing
    if (!causal || kv0 <= wg_row0 + 63) {
      // s = q.k^T and dp = do.v^T (queries x keys)
      float s_acc[BN / 2], dp_acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) s_acc[i] = dp_acc[i] = 0.f;
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wg::mma_ss<BN>(s_acc, wg::desc_k_major(qs, BM, wgi * 64, kk),
                       wg::desc_k_major(kst, BN, 0, kk), 1);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wg::mma_ss<BN>(dp_acc, wg::desc_k_major(dos, BM, wgi * 64, kk),
                       wg::desc_k_major(vst, BN, 0, kk), 1);
      wg::commit();
      wg::wait<0>();
      wg::fence_regs(s_acc);
      wg::fence_regs(dp_acc);

      // p = exp(s scale - lse), zero by selection where masked or padded
      // (a padded query's lse is not a number to trust); ds = p (dp -
      // delta) in place of s
      const bool edge = kv0 + BN > s || wg_row0 + 64 > s ||
                        (causal && kv0 + BN - 1 > wg_row0);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int r = (i >> 1) & 1;
        float p = exp2f(fmaf(s_acc[i], scale_log2, -lse2[r]));
        if (edge) {
          const int key = kv0 + wg::frag_col(i), row = row_lo + 8 * r;
          p = row < s && key < s && (!causal || key <= row) ? p : 0.f;
        }
        s_acc[i] = p * (dp_acc[i] - dlt[r]);
      }
      // dq += bf16(ds).k
      uint32_t da[BN / 16][4];
      wg::to_a_frags<BN>(s_acc, da);
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wg::mma_rs<2 * NACC>(dq_acc, da[kk], wg::desc_mn_major(kst, BN, kk),
                             1);
      wg::commit();
      wg::wait<0>();
      wg::fence_regs(dq_acc);
    }
    __syncthreads();  // the stage is consumed before it is refilled
  }
  store_acc<D>(head_base(dq, st, kDQ, batch, head), st.v[kDQ + 1], dq_acc,
               wg_row0, s, scale);
}

// ------------------------------------ K3, bfloat16: dk, dv on tensor cores
template <int D>
constexpr size_t dkv_tc_smem_bytes() {
  // k and v tiles, two stages of q and do tiles, lse [2][64], delta
  // [64], and room to align the base
  return 2 * wg::tile_bytes<kTcKeys, D>() +
         4 * wg::tile_bytes<kTcQueries, D>() + 3 * kTcQueries * 4 + 1024;
}

// Grid: one block per (64-key tile, head, batch), the key tile slowest,
// so causal calls start with key tile 0, which walks every query tile.
template <int D>
__global__ void __launch_bounds__(128, 1)
    bwd_dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ o,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ lse, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int s, int h, int n_bh,
                      Strides st, float scale, int causal) {
  constexpr int BK = kTcKeys, BQ = kTcQueries;
  constexpr int NACC = wg::padded_cols<D>() / 2;  // dk, dv registers each
  constexpr uint32_t kTile = wg::tile_bytes<BQ, D>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ks = (wg::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t vs = ks + wg::tile_bytes<BK, D>();
  const uint32_t qs = vs + wg::tile_bytes<BK, D>();  // stage i: qs + 2i kTile
  const uint32_t dos = qs + kTile;                   // stage i: dos + 2i kTile
  float* lse_s =
      reinterpret_cast<float*>(smem_ptr(smem_raw, qs + 4 * kTile));  // [2][BQ]
  float* delta_s = lse_s + 2 * BQ;                                   // [BQ]

  const int k0 = (blockIdx.x / n_bh) * BK;
  const int head = blockIdx.x % n_bh % h, batch = blockIdx.x % n_bh / h;
  const bf16* qb = head_base(q, st, kQ, batch, head);
  const bf16* kb = head_base(k, st, kK, batch, head);
  const bf16* vb = head_base(v, st, kV, batch, head);
  const bf16* ob = head_base(o, st, kO, batch, head);
  const bf16* dob = head_base(dout, st, kDO, batch, head);
  const float* lseb = lse + (static_cast<int64_t>(batch) * h + head) * s;

  // causal: query tiles wholly before this key tile see none of it
  const int q_begin = causal ? k0 : 0;
  const int n_q = (s - q_begin + BQ - 1) / BQ;
  auto load_stage = [&](int stage, int q0) {
    wg::load_tile<BQ, D, 128>(qs + 2 * stage * kTile, qb, st.v[kQ + 1], q0, s);
    wg::load_tile<BQ, D, 128>(dos + 2 * stage * kTile, dob, st.v[kDO + 1],
                              q0, s);
    if (threadIdx.x < BQ) {
      const int qi = q0 + threadIdx.x;
      wg::cp_async4(wg::smem_u32(lse_s + stage * BQ + threadIdx.x),
                    lseb + (qi < s ? qi : 0), qi < s);
    }
  };
  wg::load_tile<BK, D, 128>(ks, kb, st.v[kK + 1], k0, s);
  wg::load_tile<BK, D, 128>(vs, vb, st.v[kV + 1], k0, s);
  load_stage(0, q_begin);
  wg::cp_async_commit();

  float dk_acc[NACC], dv_acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  const int key_lo = k0 + wg::frag_row(0);  // this thread's keys: key_lo,
                                            // key_lo + 8
  const float scale_log2 = scale * kLog2e;

  // delta = rowsum(do * o): two threads a query, half the columns each
  const int d_row = threadIdx.x >> 1, d_col0 = (threadIdx.x & 1) * (D / 2);
  for (int it = 0; it < n_q; ++it) {
    const int q0 = q_begin + it * BQ;
    if (it + 1 < n_q) {  // prefetch the next q/do tile into the other stage
      load_stage((it + 1) & 1, q0 + BQ);
      wg::cp_async_commit();
    }
    // this thread's half row of o, loaded while the q/do tile lands
    uint4 o_part[D / 16];
    load_o_half<D>(o_part, ob, st.v[kO + 1], q0 + d_row, d_col0, s);
    if (it + 1 < n_q)
      wg::cp_async_wait<1>();
    else
      wg::cp_async_wait<0>();
    wg::fence_async_smem();
    __syncthreads();
    const uint32_t qst = qs + 2 * (it & 1) * kTile;
    const uint32_t dost = dos + 2 * (it & 1) * kTile;
    const float* lse_t = lse_s + (it & 1) * BQ;
    const float delta =
        row_delta<D>(o_part, smem_ptr(smem_raw, dost), BQ, d_row, d_col0);
    if ((threadIdx.x & 1) == 0) delta_s[d_row] = delta;

    // s^T = k.q^T and dp^T = v.do^T (keys x queries)
    float st_acc[BQ / 2], dp_acc[BQ / 2];
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) st_acc[i] = dp_acc[i] = 0.f;
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wg::mma_ss<BQ>(st_acc, wg::desc_k_major(ks, BK, 0, kk),
                     wg::desc_k_major(qst, BQ, 0, kk), 1);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wg::mma_ss<BQ>(dp_acc, wg::desc_k_major(vs, BK, 0, kk),
                     wg::desc_k_major(dost, BQ, 0, kk), 1);
    wg::commit();
    __syncthreads();  // delta is written
    wg::wait<0>();
    wg::fence_regs(st_acc);
    wg::fence_regs(dp_acc);

    // p^T = exp(s^T scale - lse), zero by selection where masked or
    // padded (a padded query's lse is not a number to trust)
    const bool edge = q0 + BQ > s || k0 + BK > s || (causal && q0 < k0 + BK);
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) {
      const int qc = wg::frag_col(i);
      float p = exp2f(fmaf(st_acc[i], scale_log2, -lse_t[qc] * kLog2e));
      if (edge) {
        const int qi = q0 + qc, key = key_lo + ((i >> 1) & 1) * 8;
        p = qi < s && key < s && (!causal || key <= qi) ? p : 0.f;
      }
      st_acc[i] = p;
    }
    // ds^T = p^T * (dp^T - delta), before either product is issued, so
    // that p and ds live as f32 only until they are packed to bf16
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i)
      dp_acc[i] = st_acc[i] * (dp_acc[i] - delta_s[wg::frag_col(i)]);
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];
    wg::to_a_frags<BQ>(st_acc, pa);
    wg::to_a_frags<BQ>(dp_acc, da);
    // dv += bf16(p^T).do; dk += bf16(ds^T).q
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      wg::mma_rs<2 * NACC>(dv_acc, pa[kk], wg::desc_mn_major(dost, BQ, kk), 1);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      wg::mma_rs<2 * NACC>(dk_acc, da[kk], wg::desc_mn_major(qst, BQ, kk), 1);
    wg::commit();
    wg::wait<0>();
    wg::fence_regs(dv_acc);
    wg::fence_regs(dk_acc);
    __syncthreads();  // the stage and delta are consumed before reuse
  }

  store_acc<D>(head_base(dk, st, kDK, batch, head), st.v[kDK + 1], dk_acc, k0,
               s, scale);
  store_acc<D>(head_base(dv, st, kDV, batch, head), st.v[kDV + 1], dv_acc, k0,
               s, 1.f);
}

// ------------------------- K4, bfloat16: dq, dk, dv fused on tensor cores
template <int D>
constexpr size_t fused_tc_smem_bytes() {
  // q, k, v and do tiles, the p^T and ds^T tiles (64 x 64), lse and
  // delta [64], and room to align the base
  return 4 * wg::tile_bytes<kFusedSeq, D>() +
         2 * wg::tile_bytes<kFusedSeq, kFusedSeq>() + 2 * kFusedSeq * 4 +
         1024;
}

// Grid: one block (one warpgroup) per (head, batch).
template <int D>
__global__ void __launch_bounds__(128, 1)
    bwd_fused_tc_kernel(const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ o,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse, bf16* __restrict__ dq,
                        bf16* __restrict__ dk, bf16* __restrict__ dv, int s,
                        int h, Strides st, float scale, int causal) {
  constexpr int S = kFusedSeq;
  constexpr int NACC = wg::padded_cols<D>() / 2;  // one gradient's registers
  constexpr uint32_t kTile = wg::tile_bytes<S, D>();
  constexpr uint32_t kScores = wg::tile_bytes<S, S>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t qs = (wg::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t ks = qs + kTile, vs = ks + kTile, dos = vs + kTile;
  const uint32_t pts = dos + kTile;     // p^T: keys x queries
  const uint32_t dsts = pts + kScores;  // ds^T
  float* lse_s =
      reinterpret_cast<float*>(smem_ptr(smem_raw, dsts + kScores));  // [S]
  float* delta_s = lse_s + S;                                         // [S]

  const int head = blockIdx.x % h, batch = blockIdx.x / h;
  const float* lseb = lse + (static_cast<int64_t>(batch) * h + head) * s;
  wg::load_tile<S, D, 128>(qs, head_base(q, st, kQ, batch, head),
                           st.v[kQ + 1], 0, s);
  wg::load_tile<S, D, 128>(ks, head_base(k, st, kK, batch, head),
                           st.v[kK + 1], 0, s);
  wg::load_tile<S, D, 128>(vs, head_base(v, st, kV, batch, head),
                           st.v[kV + 1], 0, s);
  wg::load_tile<S, D, 128>(dos, head_base(dout, st, kDO, batch, head),
                           st.v[kDO + 1], 0, s);
  if (threadIdx.x < S)
    wg::cp_async4(wg::smem_u32(lse_s + threadIdx.x),
                  lseb + (threadIdx.x < s ? threadIdx.x : 0), threadIdx.x < s);
  wg::cp_async_commit();

  {  // delta: two threads a query
    const int d_row = threadIdx.x >> 1, d_col0 = (threadIdx.x & 1) * (D / 2);
    uint4 o_part[D / 16];
    load_o_half<D>(o_part, head_base(o, st, kO, batch, head), st.v[kO + 1],
                   d_row, d_col0, s);
    wg::cp_async_wait<0>();
    wg::fence_async_smem();
    __syncthreads();
    const float delta =
        row_delta<D>(o_part, smem_ptr(smem_raw, dos), S, d_row, d_col0);
    if ((threadIdx.x & 1) == 0) delta_s[d_row] = delta;
  }

  // s = q.k^T and dp = do.v^T (queries x keys), once
  float s_acc[S / 2], dp_acc[S / 2];
#pragma unroll
  for (int i = 0; i < S / 2; ++i) s_acc[i] = dp_acc[i] = 0.f;
  wg::fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wg::mma_ss<S>(s_acc, wg::desc_k_major(qs, S, 0, kk),
                  wg::desc_k_major(ks, S, 0, kk), 1);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wg::mma_ss<S>(dp_acc, wg::desc_k_major(dos, S, 0, kk),
                  wg::desc_k_major(vs, S, 0, kk), 1);
  wg::commit();
  __syncthreads();  // delta is written
  wg::wait<0>();
  wg::fence_regs(s_acc);
  wg::fence_regs(dp_acc);

  // p = exp(s scale - lse), zero by selection where masked or padded;
  // ds = p (dp - delta). Both are rounded to bf16 once: ds as the A
  // fragments of dq's product, p and ds stored transposed (element
  // (query r, key c) at row c, column r) for dv's and dk's.
  const float scale_log2 = scale * kLog2e;
  uint8_t* pt_p = smem_ptr(smem_raw, pts);
  uint8_t* dst_p = smem_ptr(smem_raw, dsts);
#pragma unroll
  for (int i = 0; i < S / 2; ++i) {
    const int row = wg::frag_row(i), key = wg::frag_col(i);
    float p = exp2f(fmaf(s_acc[i], scale_log2, -lse_s[row] * kLog2e));
    p = row < s && key < s && (!causal || key <= row) ? p : 0.f;
    const float ds = p * (dp_acc[i] - delta_s[row]);
    const uint32_t at = wg::tile_offset(key, row, S);
    *reinterpret_cast<bf16*>(pt_p + at) = __float2bfloat16(p);
    *reinterpret_cast<bf16*>(dst_p + at) = __float2bfloat16(ds);
    dp_acc[i] = ds;
  }
  uint32_t da[S / 16][4];
  wg::to_a_frags<S>(dp_acc, da);
  wg::fence_async_smem();  // the p^T / ds^T stores, for wgmma's reads
  __syncthreads();

  float acc[NACC];
  // dq = bf16(ds).k (RS, k MN-major)
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
  wg::fence();
#pragma unroll
  for (int kk = 0; kk < S / 16; ++kk)
    wg::mma_rs<2 * NACC>(acc, da[kk], wg::desc_mn_major(ks, S, kk), 1);
  wg::commit();
  wg::wait<0>();
  wg::fence_regs(acc);
  store_acc<D>(head_base(dq, st, kDQ, batch, head), st.v[kDQ + 1], acc, 0, s,
               scale);
  // dv = bf16(p)^T.do (SS, p^T K-major, do MN-major)
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
  wg::fence();
#pragma unroll
  for (int kk = 0; kk < S / 16; ++kk)
    wg::mma_ss_mn<2 * NACC>(acc, wg::desc_k_major(pts, S, 0, kk),
                            wg::desc_mn_major(dos, S, kk), 1);
  wg::commit();
  wg::wait<0>();
  wg::fence_regs(acc);
  store_acc<D>(head_base(dv, st, kDV, batch, head), st.v[kDV + 1], acc, 0, s,
               1.f);
  // dk = bf16(ds)^T.q (SS, ds^T K-major, q MN-major)
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
  wg::fence();
#pragma unroll
  for (int kk = 0; kk < S / 16; ++kk)
    wg::mma_ss_mn<2 * NACC>(acc, wg::desc_k_major(dsts, S, 0, kk),
                            wg::desc_mn_major(qs, S, kk), 1);
  wg::commit();
  wg::wait<0>();
  wg::fence_regs(acc);
  store_acc<D>(head_base(dk, st, kDK, batch, head), st.v[kDK + 1], acc, 0, s,
               scale);
}

// ------------------------------------------------------------ launchers
enum Which { kDq = 0, kDkv = 1, kFused = 2 };

// One call's arguments; the launcher gives the pointers their type.
struct Call {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  void *dq, *dk, *dv;
  int b, s, h;
  Strides st;
  int causal;
  float scale;
  cudaStream_t stream;
  int* info;
};

// float32: the CUDA-core kernels, grid (64-row tiles, heads, batch).
template <int D>
int launch_f32(Which which, const Call& c) {
  const float* Q = static_cast<const float*>(c.q);
  const float* K = static_cast<const float*>(c.k);
  const float* V = static_cast<const float*>(c.v);
  const float* O = static_cast<const float*>(c.o);
  const float* DO = static_cast<const float*>(c.dout);
  float* dq = static_cast<float*>(c.dq);
  float* dk = static_cast<float*>(c.dk);
  float* dv = static_cast<float*>(c.dv);
  const dim3 tiles((c.s + kTileRows - 1) / kTileRows, c.h, c.b);
  if (which == kDq)
    return wg::run(bwd_dq_kernel<D>, tiles, kThreads, dq_smem_bytes<D>(),
                   c.stream, c.info, Q, K, V, O, DO, c.lse, dq, c.s, c.st,
                   c.scale, c.causal);
  if (which == kDkv)
    return wg::run(bwd_dkv_kernel<D>, tiles, kThreads, dkv_smem_bytes<D>(),
                   c.stream, c.info, Q, K, V, O, DO, c.lse, dk, dv, c.s, c.st,
                   c.scale, c.causal);
  return wg::run(bwd_fused_kernel<D>, dim3(1, c.h, c.b), kThreads,
                 fused_smem_bytes<D>(), c.stream, c.info, Q, K, V, O, DO,
                 c.lse, dq, dk, dv, c.s, c.st, c.scale, c.causal);
}

// bfloat16: the tensor-core kernels, a 1-D grid each.
template <int D>
int launch_tc(Which which, const Call& c) {
  const bf16* Q = static_cast<const bf16*>(c.q);
  const bf16* K = static_cast<const bf16*>(c.k);
  const bf16* V = static_cast<const bf16*>(c.v);
  const bf16* O = static_cast<const bf16*>(c.o);
  const bf16* DO = static_cast<const bf16*>(c.dout);
  bf16* dq = static_cast<bf16*>(c.dq);
  bf16* dk = static_cast<bf16*>(c.dk);
  bf16* dv = static_cast<bf16*>(c.dv);
  const int64_t bh = static_cast<int64_t>(c.b) * c.h;
  const int rows =
      which == kFused ? c.s : which == kDq ? kDqQueries : kTcKeys;
  const int n_tiles = (c.s + rows - 1) / rows;
  const int64_t blocks = n_tiles * bh;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks));
  if (which == kFused)
    return wg::run(bwd_fused_tc_kernel<D>, grid, 128, fused_tc_smem_bytes<D>(),
                   c.stream, c.info, Q, K, V, O, DO, c.lse, dq, dk, dv, c.s,
                   c.h, c.st, c.scale, c.causal);
  if (which == kDkv)
    return wg::run(bwd_dkv_tc_kernel<D>, grid, 128, dkv_tc_smem_bytes<D>(),
                   c.stream, c.info, Q, K, V, O, DO, c.lse, dk, dv, c.s, c.h,
                   static_cast<int>(bh), c.st, c.scale, c.causal);
  return wg::run(bwd_dq_tc_kernel<D>, grid, 256, dq_tc_smem_bytes<D>(),
                 c.stream, c.info, Q, K, V, O, DO, c.lse, dq, c.s, c.h,
                 static_cast<int>(bh), n_tiles, c.st, c.scale, c.causal);
}

// 1: tensor-core kernel (every bfloat16 call), 0: CUDA-core kernel
// (every float32 call), -1: no kernel for (dtype, d).
int route(int dtype, int d) {
  if ((d != 32 && d != 64 && d != 128) || (dtype != 0 && dtype != 1))
    return -1;
  return dtype;
}

int backward(Which which, const void* q, const void* k, const void* v,
             const void* o, const void* dout, const float* lse, void* dq,
             void* dk, void* dv, int dtype, int b, int s, int h, int d,
             const int64_t* strides, int causal, float scale, void* stream,
             int* info = nullptr) {
  if (b <= 0 || s <= 0 || h <= 0) return 0;  // nothing to compute
  if (h > 65535 || b > 65535 || (which == kFused && s > kFusedSeq))
    return static_cast<int>(cudaErrorInvalidValue);
  const int r = route(dtype, d);
  if (r < 0) return static_cast<int>(cudaErrorInvalidValue);
  // the tensor-core kernels read q, k, v, o, do 16 bytes at a time
  const void* const ptrs[5] = {q, k, v, o, dout};
  if (r == 1 && !wg::aligned16(ptrs, 5, strides, 15))
    return static_cast<int>(cudaErrorInvalidValue);
  Call c{q, k, v, o, dout, lse, dq, dk, dv, b, s, h, {}, causal, scale,
         static_cast<cudaStream_t>(stream), info};
  for (int i = 0; i < 24; ++i) c.st.v[i] = strides[i];
  switch (d) {
    case 32: return r == 1 ? launch_tc<32>(which, c) : launch_f32<32>(which, c);
    case 64: return r == 1 ? launch_tc<64>(which, c) : launch_f32<64>(which, c);
    default: return r == 1 ? launch_tc<128>(which, c) : launch_f32<128>(which, c);
  }
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

// Which kernel an entry launches for (dtype, d): 1 the tensor-core
// kernel, 0 the CUDA-core kernel, -1 none. which: 0 = K2, 1 = K3, 2 = K4
// (all three route alike).
extern "C" int dmt_flash_attention_bwd_route(int which, int dtype, int d) {
  return which >= kDq && which <= kFused ? route(dtype, d) : -1;
}

// What a [b, s, h, d] call of kernel `which` would launch, without
// launching it: info[0..2] = blocks resident per SM, threads a block,
// dynamic shared memory bytes. Returns a CUDA error code (0 on success).
extern "C" int dmt_flash_attention_bwd_occupancy(int which, int dtype, int b,
                                                 int s, int h, int d,
                                                 int* info) {
  if (which < kDq || which > kFused) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t strides[24] = {};  // aligned; not read
  return backward(static_cast<Which>(which), nullptr, nullptr, nullptr,
                  nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, dtype,
                  b, which == kFused ? (s < kFusedSeq ? s : kFusedSeq) : s, h,
                  d, strides, 1, 1.f, nullptr, info);
}
