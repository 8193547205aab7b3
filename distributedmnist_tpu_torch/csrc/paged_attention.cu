// K5: single-query paged attention for Hopper (sm_90a), plain CUDA C++.
//
// Replaces: distributedmnist_tpu/ops/pallas_paged_attention.py
// _paged_kernel, launched there by paged_attention. For every decode
// slot and head it attends the slot's newest query to the slot's whole
// context, read from a paged KV cache [num_blocks, block_size, heads,
// head_dim] through the slot's block table: scores and softmax in
// float32, scale 1/sqrt(head_dim) by default, an idle slot (length 0)
// writes exact zeros. Output is float32 [slots, heads, head_dim].
//
// What bounds it on this card: device-memory bytes. Each (slot, head)
// does 4 FLOPs per cached element it reads, far below the ~295 FLOP per
// byte at which the H100 turns compute-bound, so the least time is the
// live K/V bytes over 3.35 TB/s. The design reads the live K/V exactly
// once: the table walk stops at ceil(length / block_size) blocks and
// the last block stops at the last live position, so a 10-token
// sequence costs 10 positions, not the table's full width, and the
// reserved null block 0 that dead table entries point at is never read
// for a live position. Each block reads its own table row and length
// from global memory (the TPU kernel's scalar prefetch).
//
// Layout: one thread block per (slot, head), 4 warps. Warp w walks
// table entries w, w + 4, ... with its own online softmax (running
// max, denominator, accumulator in registers); lane l owns head_dim
// columns [l * DPL, (l + 1) * DPL), so a warp reads each cached row as
// one contiguous span. At the end the 4 partial states are merged in
// shared memory (the split-K merge of flash decoding, inside one block).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;
constexpr int kChunk = 16;  // positions scored before one softmax update
constexpr int kMaxD = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

template <typename TQ, typename TKV, int DPL>
__global__ void __launch_bounds__(kWarps * 32)
    paged_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kp,
                 const TKV* __restrict__ vp, const int* __restrict__ tables,
                 const int* __restrict__ lengths, float* __restrict__ out,
                 int heads, int block_size, int width, int64_t q_ss,
                 int64_t q_sh, float scale) {
  constexpr int D = 32 * DPL;
  __shared__ float sm_m[kWarps], sm_l[kWarps];
  __shared__ float sm_acc[kWarps * kMaxD];

  const int slot = blockIdx.x;
  const int head = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int length = lengths[slot];
  const int col0 = lane * DPL;

  float qv[DPL];
  const TQ* qrow = q + slot * q_ss + head * q_sh + col0;
#pragma unroll
  for (int i = 0; i < DPL; ++i) qv[i] = to_f32(qrow[i]);

  float m = kNegInf, l = 0.f, acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;

  const int64_t row_stride = static_cast<int64_t>(heads) * D;
  const int64_t blk_stride = row_stride * block_size;
  const int nblk = min((length + block_size - 1) / block_size, width);
  for (int j = warp; j < nblk; j += kWarps) {
    const int64_t blk = tables[slot * width + j];
    const int n = min(block_size, length - j * block_size);
    const TKV* kb = kp + blk * blk_stride + head * D + col0;
    const TKV* vb = vp + blk * blk_stride + head * D + col0;
    for (int t0 = 0; t0 < n; t0 += kChunk) {
      float sc[kChunk];
      float cmax = kNegInf;
#pragma unroll
      for (int t = 0; t < kChunk; ++t) {
        float part = 0.f;
        if (t0 + t < n) {
          const TKV* kr = kb + (t0 + t) * row_stride;
#pragma unroll
          for (int i = 0; i < DPL; ++i) part = fmaf(qv[i], to_f32(kr[i]), part);
        }
        const float x = warp_sum(part) * scale;
        sc[t] = (t0 + t < n) ? x : kNegInf;
        cmax = fmaxf(cmax, sc[t]);
      }
      const float m_new = fmaxf(m, cmax);
      const float corr = expf(m - m_new);
      l *= corr;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[i] *= corr;
#pragma unroll
      for (int t = 0; t < kChunk; ++t) {
        if (t0 + t < n) {  // dead positions are never read
          const float p = expf(sc[t] - m_new);
          const TKV* vr = vb + (t0 + t) * row_stride;
          l += p;
#pragma unroll
          for (int i = 0; i < DPL; ++i) acc[i] = fmaf(p, to_f32(vr[i]), acc[i]);
        }
      }
      m = m_new;
    }
  }

  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < DPL; ++i) sm_acc[warp * D + col0 + i] = acc[i];
  __syncthreads();

  float mx = kNegInf;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w]);
  float* orow = out + (static_cast<int64_t>(slot) * heads + head) * D;
  for (int c = threadIdx.x; c < D; c += kWarps * 32) {
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(sm_m[w] - mx);  // 0 for a warp that saw nothing
      num = fmaf(sm_acc[w * D + c], f, num);
      den = fmaf(sm_l[w], f, den);
    }
    orow[c] = length > 0 ? num / fmaxf(den, 1e-30f) : 0.f;
  }
}

template <typename TQ, typename TKV>
int dispatch_d(const void* q, const void* k, const void* v, const int* t,
               const int* len, float* o, int slots, int heads, int d,
               int block_size, int width, int64_t q_ss, int64_t q_sh,
               float scale, cudaStream_t st) {
  dim3 grid(slots, heads);
  const TQ* qq = static_cast<const TQ*>(q);
  const TKV* kk = static_cast<const TKV*>(k);
  const TKV* vv = static_cast<const TKV*>(v);
  switch (d) {
    case 32:
      paged_kernel<TQ, TKV, 1><<<grid, kWarps * 32, 0, st>>>(
          qq, kk, vv, t, len, o, heads, block_size, width, q_ss, q_sh, scale);
      break;
    case 64:
      paged_kernel<TQ, TKV, 2><<<grid, kWarps * 32, 0, st>>>(
          qq, kk, vv, t, len, o, heads, block_size, width, q_ss, q_sh, scale);
      break;
    case 128:
      paged_kernel<TQ, TKV, 4><<<grid, kWarps * 32, 0, st>>>(
          qq, kk, vv, t, len, o, heads, block_size, width, q_ss, q_sh, scale);
      break;
    case 256:
      paged_kernel<TQ, TKV, 8><<<grid, kWarps * 32, 0, st>>>(
          qq, kk, vv, t, len, o, heads, block_size, width, q_ss, q_sh, scale);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ>
int dispatch_kv(int kv_dtype, const void* q, const void* k, const void* v,
                const int* t, const int* len, float* o, int slots, int heads,
                int d, int block_size, int width, int64_t q_ss, int64_t q_sh,
                float scale, cudaStream_t st) {
  if (kv_dtype == 0)
    return dispatch_d<TQ, float>(q, k, v, t, len, o, slots, heads, d,
                                 block_size, width, q_ss, q_sh, scale, st);
  if (kv_dtype == 1)
    return dispatch_d<TQ, __nv_bfloat16>(q, k, v, t, len, o, slots, heads, d,
                                         block_size, width, q_ss, q_sh, scale,
                                         st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtypes: 0 = float32, 1 = bfloat16. q [slots, heads, d] with element
// strides (q_ss, q_sh) and a contiguous last dim; k/v pages contiguous
// [num_blocks, block_size, heads, d]; tables [slots, width] and lengths
// [slots] contiguous int32; out contiguous float32 [slots, heads, d].
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int dmt_paged_attention(const void* q, const void* k_pages,
                                   const void* v_pages, const void* tables,
                                   const void* lengths, void* out,
                                   int q_dtype, int kv_dtype, int slots,
                                   int heads, int d, int block_size,
                                   int width, int64_t q_ss, int64_t q_sh,
                                   float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (slots <= 0 || heads <= 0) return 0;
  if (heads > 65535 || block_size <= 0 || width <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* t = static_cast<const int*>(tables);
  const int* len = static_cast<const int*>(lengths);
  float* o = static_cast<float*>(out);
  if (q_dtype == 0)
    return dispatch_kv<float>(kv_dtype, q, k_pages, v_pages, t, len, o, slots,
                              heads, d, block_size, width, q_ss, q_sh, scale,
                              st);
  if (q_dtype == 1)
    return dispatch_kv<__nv_bfloat16>(kv_dtype, q, k_pages, v_pages, t, len, o,
                                      slots, heads, d, block_size, width, q_ss,
                                      q_sh, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Which kernel dmt_paged_attention launches for (q dtype, d): 0 the
// CUDA-core kernel (every supported pair), -1 none.
extern "C" int dmt_paged_attention_route(int dtype, int d) {
  const bool ok_d = d == 32 || d == 64 || d == 128 || d == 256;
  return ok_d && (dtype == 0 || dtype == 1) ? 0 : -1;
}
