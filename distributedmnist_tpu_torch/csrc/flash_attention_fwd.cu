// K1: flash-attention forward for Hopper (sm_90a), CUDA C++.
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
// past the sequence end masked with the finite -1e30. Inputs are read
// through their strides (the model passes q = qkv[:, :, 0], a strided
// view), so no copy is made before the call; the last dimension must be
// contiguous.
//
// Two kernels, chosen by dtype alone (dmt_flash_attention_fwd_route):
//
// bfloat16 -> flash_fwd_tc_kernel, on the tensor cores (wgmma). What
// bounds it: at the training shape [16, 1024, 16, 128] one call moves
// 0.27 GB (0.080 ms at 3.35 TB/s) and does 68.8 GFLOP of causal
// q.k^T and p.v (0.070 ms at 989 TFLOP/s): bytes and operations are
// about equal, so only the tensor cores can come near either bound.
// Design: a block owns 128 query rows (two consumer warpgroups of 64);
// the q tile is loaded once, k/v tiles of 64 keys stream through a
// 2-stage cp.async ring in the 128-byte-swizzled layout wgmma reads
// (csrc/wgmma.cuh). s = q.k^T is an SS wgmma
// (m64n64k16, both operands K-major); the online softmax runs on the
// accumulator fragment in registers (row max and sum across the 4
// lanes that share a row, exp2f with scale*log2(e) folded in); p is
// rounded to bf16 in registers, as the reference rounds it to the input
// dtype before p.v, and is the A operand of o += p.v (RS wgmma, v
// MN-major). Causal blocks walk only the key tiles at or below their
// diagonal and launch heaviest first. Two blocks share an SM (up to
// head_dim 128), so one block's softmax overlaps the other's wgmma.
//
// float32 -> flash_fwd_kernel, on the CUDA cores in float32 (tensor
// cores would mean TF32 and miss the float32 agreement at 1e-4): one
// block per 64-row query tile, 8 warps of 8 rows; 32-key tiles, lane j
// owns key j for the scores and column slice {lane + 32 i} for p.v.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

namespace wg = dmt_wgmma;

constexpr float kNegInf = -1e30f;
constexpr int kBlockM = 64;  // query rows per thread block
constexpr int kBlockN = 32;  // keys per shared-memory tile (one per lane)
constexpr int kWarps = 8;
constexpr int kRowsPerWarp = kBlockM / kWarps;
constexpr unsigned kFull = 0xffffffffu;

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

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, int s,
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

  const float* qb = q + batch * q_sb + head * q_sh;
  const float* kb = k + batch * k_sb + head * k_sh;
  const float* vb = v + batch * v_sb + head * v_sh;
  float* ob = o + batch * o_sb + head * o_sh;

  for (int idx = tid; idx < kBlockM * D; idx += kWarps * 32) {
    const int r = idx / D, c = idx - (idx / D) * D;
    const int row = q0 + r;
    qs[idx] = row < s ? qb[row * q_ss + c] : 0.f;
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
      ks[j * (D + 1) + c] = ok ? kb[key * k_ss + c] : 0.f;
      vs[j * D + c] = ok ? vb[key * v_ss + c] : 0.f;
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
        ob[row * o_ss + lane + 32 * i] = acc[r][i] * inv;
      // K1-lse: m and l are warp-uniform after the reductions, so lane 0
      // writes the row's log-sum-exp
      if (lse != nullptr && lane == 0)
        lse[(static_cast<int64_t>(batch) * gridDim.y + head) * s + row] =
            m[r] + logf(fmaxf(l[r], 1e-30f));
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int s, int h, const int64_t* st, int causal, float scale,
           float* lse, cudaStream_t stream, int* info) {
  return wg::run(flash_fwd_kernel<D>, dim3((s + kBlockM - 1) / kBlockM, h, b),
                 kWarps * 32, smem_bytes<D>(), stream, info,
                 static_cast<const float*>(q), static_cast<const float*>(k),
                 static_cast<const float*>(v), static_cast<float*>(o), s,
                 st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
                 st[9], st[10], st[11], scale, causal, lse);
}

// ------------------------------------------------ bfloat16: tensor cores
using bf16 = __nv_bfloat16;

constexpr int kTcBlockM = 128;  // query rows a block: 2 warpgroups of 64
constexpr int kTcBlockN = 64;   // keys a k/v tile
constexpr int kTcThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Element strides (batch, seq, head) of q, k, v, o.
struct Strides {
  int64_t v[12];
};

template <int D>
constexpr size_t tc_smem_bytes() {
  // the q tile, two stages of k and v tiles, and room to align the base
  return wg::tile_bytes<kTcBlockM, D>() + 4 * wg::tile_bytes<kTcBlockN, D>() +
         1024;
}

// Two consumer warpgroups, 64 query rows each. Grid: one block per
// (query tile, head, batch), the query tile slowest. Up to head_dim 128
// the kernel is held to 128 registers a thread, so that two blocks share
// an SM and one's softmax overlaps the other's products.
template <int D>
__global__ void __launch_bounds__(kTcThreads, D <= 128 ? 2 : 1)
    flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, bf16* __restrict__ o,
                        int s, int h, int n_bh, int n_tiles, Strides st,
                        float scale_log2, int causal, float* __restrict__ lse) {
  constexpr int BM = kTcBlockM, BN = kTcBlockN, T = kTcThreads;
  constexpr int NACC = wg::padded_cols<D>() / 2;  // o accumulator registers
  constexpr uint32_t kStage = wg::tile_bytes<BN, D>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t qs = (wg::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t ks = qs + wg::tile_bytes<BM, D>();  // 2 stages
  const uint32_t vs = ks + 2 * kStage;               // 2 stages

  // causal calls take the heaviest query tiles (the last rows) first
  const int tile = blockIdx.x / n_bh;
  const int qt = causal ? n_tiles - 1 - tile : tile;
  const int head = blockIdx.x % n_bh % h, batch = blockIdx.x % n_bh / h;
  const bf16* qb = q + batch * st.v[0] + head * st.v[2];
  const bf16* kb = k + batch * st.v[3] + head * st.v[5];
  const bf16* vb = v + batch * st.v[6] + head * st.v[8];
  bf16* ob = o + batch * st.v[9] + head * st.v[11];

  const int q0 = qt * BM;
  const int wgi = threadIdx.x >> 7;       // this thread's warpgroup
  const int wg_row0 = q0 + wgi * 64;      // its first query row
  const int row_lo = wg_row0 + wg::frag_row(0);  // this thread's rows:
                                                 // row_lo, row_lo + 8
  const int kv_end = causal ? min(s, q0 + BM) : s;
  const int n_kv = (kv_end + BN - 1) / BN;

  wg::load_tile<BM, D, T>(qs, qb, st.v[1], q0, s);
  wg::load_tile<BN, D, T>(ks, kb, st.v[4], 0, s);
  wg::load_tile<BN, D, T>(vs, vb, st.v[7], 0, s);
  wg::cp_async_commit();

  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int t = 0; t < n_kv; ++t) {
    const int kv0 = t * BN;
    if (t + 1 < n_kv) {  // prefetch the next k/v tile into the other stage
      const uint32_t nxt = ((t + 1) & 1) * kStage;
      wg::load_tile<BN, D, T>(ks + nxt, kb, st.v[4], kv0 + BN, s);
      wg::load_tile<BN, D, T>(vs + nxt, vb, st.v[7], kv0 + BN, s);
      wg::cp_async_commit();
      wg::cp_async_wait<1>();
    } else {
      wg::cp_async_wait<0>();
    }
    wg::fence_async_smem();
    __syncthreads();
    const uint32_t kst = ks + (t & 1) * kStage, vst = vs + (t & 1) * kStage;
    // causal: a key tile wholly above this warpgroup's rows adds nothing
    if (!causal || kv0 <= wg_row0 + 63) {
      float sc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f;
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wg::mma_ss<BN>(sc, wg::desc_k_major(qs, BM, wgi * 64, kk),
                       wg::desc_k_major(kst, BN, 0, kk), 1);
      wg::commit();
      wg::wait<0>();
      wg::fence_regs(sc);

      // online softmax on the fragment, in the log2 domain
      const bool edge = kv0 + BN > s || (causal && kv0 + BN - 1 > wg_row0);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        float x = sc[i] * scale_log2;
        if (edge) {
          const int key = kv0 + wg::frag_col(i);
          const int row = row_lo + ((i >> 1) & 1) * 8;
          x = key < s && (!causal || key <= row) ? x : kNegInf;
        }
        sc[i] = x;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
      }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {  // the 4 lanes holding a row
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
        corr[r] = exp2f(m[r] - mx[r]);
        m[r] = mx[r];
        l[r] *= corr[r];  // this thread's share of the row sum
      }
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const float p = exp2f(sc[i] - m[(i >> 1) & 1]);
        l[(i >> 1) & 1] += p;
        sc[i] = p;
      }
#pragma unroll
      for (int i = 0; i < NACC; ++i) acc[i] *= corr[(i >> 1) & 1];

      // o += bf16(p).v
      uint32_t pa[BN / 16][4];
      wg::to_a_frags<BN>(sc, pa);
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wg::mma_rs<2 * NACC>(acc, pa[kk], wg::desc_mn_major(vst, BN, kk), 1);
      wg::commit();
      wg::wait<0>();
      wg::fence_regs(acc);
    }
    __syncthreads();  // the stage is consumed before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
  }
#pragma unroll
  for (int i = 0; i < NACC; i += 2) {
    const int row = row_lo + ((i >> 1) & 1) * 8, col = wg::frag_col(i);
    if (row < s && col < D) {
      const float inv = 1.f / fmaxf(l[(i >> 1) & 1], 1e-30f);
      *reinterpret_cast<__nv_bfloat162*>(ob + row * st.v[10] + col) =
          __floats2bfloat162_rn(acc[i] * inv, acc[i + 1] * inv);
    }
  }
  if (lse != nullptr && (threadIdx.x & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_lo + 8 * r;
      if (row < s)
        lse[(static_cast<int64_t>(batch) * h + head) * s + row] =
            (m[r] + log2f(fmaxf(l[r], 1e-30f))) * kLn2;
    }
  }
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* o, int b,
              int s, int h, const Strides& st, int causal, float scale,
              float* lse, cudaStream_t stream, int* info) {
  const int n_tiles = (s + kTcBlockM - 1) / kTcBlockM;
  const int64_t blocks = static_cast<int64_t>(n_tiles) * b * h;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  return wg::run(flash_fwd_tc_kernel<D>, dim3(static_cast<unsigned>(blocks)),
                 kTcThreads, tc_smem_bytes<D>(), stream, info,
                 static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                 static_cast<const bf16*>(v), static_cast<bf16*>(o), s, h,
                 b * h, n_tiles, st, scale * kLog2e, causal, lse);
}

// 1: tensor-core kernel (bfloat16), 0: CUDA-core kernel (float32),
// -1: no kernel for (dtype, d).
int route(int dtype, int d) {
  if (d != 32 && d != 64 && d != 128 && d != 256) return -1;
  return dtype == 1 ? 1 : dtype == 0 ? 0 : -1;
}

int forward(const void* q, const void* k, const void* v, void* o, int dtype,
            int b, int s, int h, int d, const int64_t* strides, int causal,
            float scale, float* lse, void* stream, int* info) {
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (b <= 0 || s <= 0 || h <= 0) return 0;  // nothing to compute
  if (h > 65535 || b > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int r = route(dtype, d);
  if (r == 0) {
    switch (d) {
      case 32: return launch<32>(q, k, v, o, b, s, h, strides, causal, scale, lse, cs, info);
      case 64: return launch<64>(q, k, v, o, b, s, h, strides, causal, scale, lse, cs, info);
      case 128: return launch<128>(q, k, v, o, b, s, h, strides, causal, scale, lse, cs, info);
      case 256: return launch<256>(q, k, v, o, b, s, h, strides, causal, scale, lse, cs, info);
    }
  }
  const void* const ptrs[3] = {q, k, v};
  if (r != 1 || !wg::aligned16(ptrs, 3, strides, 9))
    return static_cast<int>(cudaErrorInvalidValue);
  Strides st;
  for (int i = 0; i < 12; ++i) st.v[i] = strides[i];
  switch (d) {
    case 32: return launch_tc<32>(q, k, v, o, b, s, h, st, causal, scale, lse, cs, info);
    case 64: return launch_tc<64>(q, k, v, o, b, s, h, st, causal, scale, lse, cs, info);
    case 128: return launch_tc<128>(q, k, v, o, b, s, h, st, causal, scale, lse, cs, info);
    default: return launch_tc<256>(q, k, v, o, b, s, h, st, causal, scale, lse, cs, info);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. strides: 12 element strides, in the
// order (batch, seq, head) for q, k, v, o; bfloat16 calls need 16-byte
// aligned q, k, v and strides that are multiples of 8. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int dmt_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, void* o, int dtype,
                                       int b, int s, int h, int d,
                                       const int64_t* strides, int causal,
                                       float scale, void* stream) {
  return forward(q, k, v, o, dtype, b, s, h, d, strides, causal, scale,
                 nullptr, stream, nullptr);
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
                 stream, nullptr);
}

// Which kernel the two entries launch for (dtype, d): 1 the tensor-core
// kernel, 0 the CUDA-core kernel, -1 none.
extern "C" int dmt_flash_attention_fwd_route(int dtype, int d) {
  return route(dtype, d);
}

// What a [b, s, h, d] call would launch, without launching it: info[0..2]
// = blocks resident per SM, threads a block, dynamic shared memory
// bytes. Returns a CUDA error code (0 on success).
extern "C" int dmt_flash_attention_fwd_occupancy(int dtype, int b, int s,
                                                 int h, int d, int* info) {
  const int64_t strides[12] = {};  // aligned; not read
  return forward(nullptr, nullptr, nullptr, nullptr, dtype, b, s, h, d,
                 strides, 1, 1.f, nullptr, nullptr, info);
}
