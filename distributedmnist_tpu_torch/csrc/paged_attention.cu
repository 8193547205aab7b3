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
// live K/V bytes over 3.35 TB/s. No tensor cores: one query per (slot,
// head) makes every product a single row, where wgmma wants 64 rows and
// mma.sync would waste 15 of its 16; and the cores are not the limit.
// At decode sizes (a few MB) a call is latency-bound, so the design cuts
// the dependent steps on a block's path and keeps blocks from waiting
// on one another:
// * Flash decoding inside one launch. The grid is (split, head, slot)
//   with clusters of kSplits blocks along split: block c of a (slot,
//   head) cluster takes table entries [c * P, (c + 1) * P), P =
//   ceil(width / kSplits), with its own online softmax. The grid comes
//   from the table width, which the host knows, never from the lengths,
//   which live on the card. Each live block c > 0 pushes its (max,
//   denominator, accumulator) into block 0's shared memory (distributed
//   shared memory) and arrives on an mbarrier there; block 0 merges them
//   in the fixed order c = 0, 1, ..., so the output is bitwise the same
//   from call to call. A block whose range starts at or past the length
//   loads nothing and leaves at once. No scratch tensor, no atomics, no
//   second launch.
// * Every load in flight at once, by the TMA. The pages are a 4-D tensor
//   map [num_blocks, block_size, heads, head_dim] with box [1, R, 1,
//   head_dim]: the block-table entry is the box's first coordinate, so
//   the table walk is the copy (as the Pallas index map (t[s, j], 0, 0)
//   is). One thread issues a K and a V box for each chunk of R positions
//   of a page, into a ring of shared-memory stages with an mbarrier each,
//   all of them before any is reduced; a table longer than the ring
//   wraps it. Boxes never cross a page (rows past block_size are the
//   TMA's zero fill), only live pages are read, and positions at or past
//   the length are masked, so the null block 0 is never read.
// * Wide reads and parallel scores. A row of head_dim is read from
//   shared memory as 16-byte vectors by a group of kLanesPerRow lanes (16
//   for bf16 at head_dim 128). Over the landed stages, each of the
//   block's kGroups groups scores kStep of its rows at a time, reduces
//   those dot products together, interleaved across rows
//   (log2(kLanesPerRow) shuffles each), then updates its online softmax
//   once; the groups' states merge in a fixed order.
//
// Shared memory: stages of 2 x R x head_dim elements (R = block_size, at
// most 256 and a 32 KB stage), up to kMaxStages and 160 KB, then the
// block's P table entries; block 0's merge buffers are static (at most
// 7 KB). At the decode path's shape (bf16, head_dim 128, 36 blocks of
// 16 positions) 5 stages of 8 KB: 40 KB and 32 bytes.

#include <algorithm>

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kSplits = 8;    // blocks of a cluster (the portable maximum)
constexpr int kThreads = 128;
constexpr int kMaxStages = 8;
constexpr int kStep = 4;  // rows a group scores together
constexpr int kMaxStageBytes = 32 * 1024;
constexpr int kMaxRingBytes = 160 * 1024;
constexpr int kMaxSmem = 200 * 1024;  // dynamic: ring and table entries

// The geometry of one (page dtype, head_dim) instantiation.
template <typename TKV, int D>
struct Geometry {
  static constexpr int kVec = 16 / static_cast<int>(sizeof(TKV));
  static constexpr int kVecsPerRow = D / kVec;
  static constexpr int kLanesPerRow = kVecsPerRow < 32 ? kVecsPerRow : 32;
  static constexpr int kVecsPerLane = kVecsPerRow / kLanesPerRow;
  static constexpr int kCols = kVecsPerLane * kVec;  // columns a lane owns
  static constexpr int kGroups = kThreads / kLanesPerRow;
  static constexpr int kRowBytes = D * static_cast<int>(sizeof(TKV));
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 16 bytes of shared memory as floats: 4 float32 or 8 bf16 values.
__device__ __forceinline__ void unpack(const float* p, float* f) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  f[0] = u.x, f[1] = u.y, f[2] = u.z, f[3] = u.w;
}
__device__ __forceinline__ void unpack(const __nv_bfloat16* p, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x, f[2 * i + 1] = x.y;
  }
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// -- mbarriers, TMA tensor copies and the cluster barrier (PTX, sm_90)
__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}
// The next phase of `bar` completes once `bytes` more have landed.
__device__ __forceinline__ void bar_expect(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
// Wait for the phase of `bar` with this parity to complete, acquiring at
// cluster scope (what other blocks stored before arriving is visible).
// A phase that never completes traps after a second, so a lost arrival
// fails the launch instead of hanging the card.
__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {
  const unsigned addr = smem_u32(bar);
  uint64_t t0 = 0;
  for (int n = 0;; ++n) {
    unsigned done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    uint64_t now;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
    if (n == 0) t0 = now;
    else if (now - t0 > 1000000000ull) __trap();
  }
}
// One box of a 4-D tensor map into shared memory by the TMA, counted on
// `bar`; the coordinates go innermost first.
__device__ __forceinline__ void tma_load(const CUtensorMap* map, void* dst,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_u32(bar))
      : "memory");
}
// Arrive, releasing at cluster scope, on the mbarrier at the same
// shared-memory offset as `bar` in block `rank` of the cluster.
__device__ __forceinline__ void bar_arrive_remote(uint64_t* bar, int rank) {
  asm volatile(
      "{\n.reg .b32 ra;\nmapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [ra];\n}\n" ::
          "r"(smem_u32(bar)),
      "r"(rank)
      : "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

template <typename TQ, typename TKV, int D>
__global__ void __cluster_dims__(kSplits, 1, 1) __launch_bounds__(kThreads)
    paged_split_kernel(const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       const TQ* __restrict__ q,
                       const int* __restrict__ tables,
                       const int* __restrict__ lengths,
                       float* __restrict__ out, int heads, int block_size,
                       int width, int rows_per_split, int chunk_rows,
                       int stages, int stage_bytes, int ring_bytes,
                       int64_t q_ss, int64_t q_sh, float scale) {
  using G = Geometry<TKV, D>;
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ uint64_t stage_bar[kMaxStages];
  // block 0 only: the other blocks' states, pushed here, and the barrier
  // they arrive on once their part is stored
  __shared__ uint64_t merge_bar;
  __shared__ float recv_ml[kSplits - 1][2];
  __shared__ float recv_acc[kSplits - 1][D];

  const int split = blockIdx.x;  // the block's rank in its cluster
  const int head = blockIdx.y;
  const int slot = blockIdx.z;
  const int t = threadIdx.x;
  const int length = lengths[slot];
  // the block's table entries, read beside the length (not after it)
  const int pages = rows_per_split / block_size;
  const int page0 = split * pages;
  int* tab = reinterpret_cast<int*>(ring + ring_bytes);
  const int* table = tables + static_cast<int64_t>(slot) * width + page0;
  for (int j = t; j < pages && page0 + j < width; j += kThreads)
    tab[j] = table[j];
  const int live_len = max(0, min(length, width * block_size));
  const int live_splits = (live_len + rows_per_split - 1) / rows_per_split;
  const int row0 = split * rows_per_split;
  const int row1 = min(row0 + rows_per_split, live_len);
  // chunks: each live page's rows, chunk_rows at a time
  const int per_page = (block_size + chunk_rows - 1) / chunk_rows;
  const int nchunks =
      split < live_splits
          ? (row1 - row0) / block_size * per_page +
                ((row1 - row0) % block_size + chunk_rows - 1) / chunk_rows
          : 0;
  if (t == 0) {
    for (int i = 0; i < stages; ++i) bar_init(&stage_bar[i], 1);
    // every thread of every other live block arrives once
    if (split == 0 && live_splits > 1)
      bar_init(&merge_bar, kThreads * (live_splits - 1));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_arrive_relaxed();  // block 0's barrier is ready for the others

  if (nchunks == 0) {  // nothing live in this block's range
    cluster_wait();
    if (split == 0) {  // an idle slot: exact zeros
      float* orow = out + (static_cast<int64_t>(slot) * heads + head) * D;
      for (int c = t; c < D; c += kThreads) orow[c] = 0.f;
    }
    return;  // no block reads this one's shared memory
  }

  __syncthreads();  // tab and the stage barriers are ready
  // chunk c: a K and a V box of chunk_rows positions of one page
  auto issue = [&](int c) {
    const int s = c % stages;
    const int pg = c / per_page;
    const int off = (c - pg * per_page) * chunk_rows;
    unsigned char* st = ring + s * stage_bytes;
    bar_expect(&stage_bar[s], 2 * chunk_rows * G::kRowBytes);
    tma_load(&k_map, st, &stage_bar[s], 0, head, off, tab[pg]);
    tma_load(&v_map, st + stage_bytes / 2, &stage_bar[s], 0, head, off,
             tab[pg]);
  };
  if (t == 0)  // every stage in flight at once
    for (int c = 0; c < stages && c < nchunks; ++c) issue(c);

  // lane li of group g owns the 16-byte vectors li, li + kLanesPerRow,
  // ... of a row; q is read once, scaled into log2 units
  const int g = t / G::kLanesPerRow;
  const int li = t % G::kLanesPerRow;
  const float qscale = scale * kLog2e;
  const TQ* qrow = q + slot * q_ss + head * q_sh;
  float qv[G::kCols], acc[G::kCols];
#pragma unroll
  for (int u = 0; u < G::kVecsPerLane; ++u)
#pragma unroll
    for (int e = 0; e < G::kVec; ++e) {
      const int col = (u * G::kLanesPerRow + li) * G::kVec + e;
      qv[u * G::kVec + e] = to_f32(qrow[col]) * qscale;
      acc[u * G::kVec + e] = 0.f;
    }
  float m = kNegInf, l = 0.f;

  // windows of landed stages; group g takes rows g, g + kGroups, ... of
  // each chunk: row slot x = w * rpg + k of the window, kStep slots at a
  // time (their dot products and shuffles interleaved, one softmax
  // update); a rolled loop keeps the code small, which every SM fetches
  const int rpg = (chunk_rows + G::kGroups - 1) / G::kGroups;
  for (int c0 = 0; c0 < nchunks;) {
    const int nw = min(stages, nchunks - c0);
    const int nslots = nw * rpg;  // the same in every thread
    // where the next slot lies, advanced slot by slot (no divisions):
    // its row k of the group in the chunk, the chunk's stage and the
    // parity of its use, and the chunk's page pg and piece sub of that
    // page; a chunk is waited for when its first slot comes
    int k = 0, stage = c0 % stages, parity = (c0 / stages) & 1;
    int pg = c0 / per_page, sub = c0 % per_page;
#pragma unroll 1
    for (int x0 = 0; x0 < nslots; x0 += kStep) {
      float sc[kStep];
      int row_at[kStep];  // byte offset of the row's K in the ring, or -1
#pragma unroll
      for (int x = 0; x < kStep; ++x) {
        sc[x] = 0.f;
        row_at[x] = -1;
        if (k == 0 && x0 + x < nslots) bar_wait(&stage_bar[stage], parity);
        const int r = g + k * G::kGroups;
        if (x0 + x < nslots && r < chunk_rows) {
          const int at = stage * stage_bytes + r * G::kRowBytes;
          const int in_page = sub * chunk_rows + r;
          if (in_page < block_size && row0 + pg * block_size + in_page < row1)
            row_at[x] = at;  // a live position
          const TKV* kr = reinterpret_cast<const TKV*>(ring + at);
#pragma unroll
          for (int u = 0; u < G::kVecsPerLane; ++u) {
            float kf[G::kVec];
            unpack(kr + (u * G::kLanesPerRow + li) * G::kVec, kf);
#pragma unroll
            for (int e = 0; e < G::kVec; ++e)
              sc[x] = fmaf(qv[u * G::kVec + e], kf[e], sc[x]);
          }
        }
        if (++k == rpg) {  // the next chunk
          k = 0;
          if (++stage == stages) stage = 0, parity ^= 1;
          if (++sub == per_page) sub = 0, ++pg;
        }
      }
#pragma unroll
      for (int o = G::kLanesPerRow / 2; o > 0; o >>= 1)
#pragma unroll
        for (int x = 0; x < kStep; ++x)
          sc[x] += __shfl_xor_sync(0xffffffffu, sc[x], o);
      float m_new = m;
#pragma unroll
      for (int x = 0; x < kStep; ++x)
        if (row_at[x] >= 0) m_new = fmaxf(m_new, sc[x]);
      const float corr = exp2f(m - m_new);
      l *= corr;
#pragma unroll
      for (int c = 0; c < G::kCols; ++c) acc[c] *= corr;
#pragma unroll
      for (int x = 0; x < kStep; ++x) {
        if (row_at[x] < 0) continue;  // a dead row's stage bytes are stale
        const float p = exp2f(sc[x] - m_new);
        l += p;
        const TKV* vr =
            reinterpret_cast<const TKV*>(ring + row_at[x] + stage_bytes / 2);
#pragma unroll
        for (int u = 0; u < G::kVecsPerLane; ++u) {
          float vf[G::kVec];
          unpack(vr + (u * G::kLanesPerRow + li) * G::kVec, vf);
#pragma unroll
          for (int e = 0; e < G::kVec; ++e)
            acc[u * G::kVec + e] = fmaf(p, vf[e], acc[u * G::kVec + e]);
        }
      }
      m = m_new;
    }
    // the ring wraps: refill the stages just read
    const int next = c0 + stages;
    c0 += nw;
    if (next < nchunks) {
      __syncthreads();
      if (t == 0)
        for (int c = next; c < next + nw && c < nchunks; ++c) issue(c);
    }
  }
  __syncthreads();  // the ring is read to the end

  // the groups' states, in the ring, merged in the fixed order g = 0, 1, ...
  float* grp_acc = reinterpret_cast<float*>(ring);
  float* grp_m = grp_acc + G::kGroups * D;
  float* grp_l = grp_m + G::kGroups;
  if (li == 0) grp_m[g] = m, grp_l[g] = l;
#pragma unroll
  for (int u = 0; u < G::kVecsPerLane; ++u)
#pragma unroll
    for (int e = 0; e < G::kVec; ++e)
      grp_acc[g * D + (u * G::kLanesPerRow + li) * G::kVec + e] =
          acc[u * G::kVec + e];
  __syncthreads();
  float mx = kNegInf, den = 0.f;
#pragma unroll
  for (int h = 0; h < G::kGroups; ++h) mx = fmaxf(mx, grp_m[h]);
#pragma unroll
  for (int h = 0; h < G::kGroups; ++h)
    den = fmaf(grp_l[h], exp2f(grp_m[h] - mx), den);
  constexpr int kColsPerThread = (D + kThreads - 1) / kThreads;
  float num[kColsPerThread];
#pragma unroll
  for (int k = 0; k < kColsPerThread; ++k) {
    const int c = t + k * kThreads;
    num[k] = 0.f;
    if (c < D)
#pragma unroll
      for (int h = 0; h < G::kGroups; ++h)
        num[k] = fmaf(grp_acc[h * D + c], exp2f(grp_m[h] - mx), num[k]);
  }

  cluster_wait();  // block 0's merge barrier is initialised
  if (split > 0) {  // push this block's state into block 0, then leave
    cg::cluster_group cluster = cg::this_cluster();
    float* racc = cluster.map_shared_rank(&recv_acc[split - 1][0], 0);
#pragma unroll
    for (int k = 0; k < kColsPerThread; ++k)
      if (t + k * kThreads < D) racc[t + k * kThreads] = num[k];
    if (t == 0) {
      float* rml = cluster.map_shared_rank(&recv_ml[split - 1][0], 0);
      rml[0] = mx, rml[1] = den;
    }
    bar_arrive_remote(&merge_bar, 0);
    return;
  }
  // block 0: merge the live blocks' states in the fixed order c = 0, 1, ...
  if (live_splits > 1) bar_wait(&merge_bar, 0);
  float gmx = mx;
  for (int c = 1; c < live_splits; ++c) gmx = fmaxf(gmx, recv_ml[c - 1][0]);
  const float w0 = exp2f(mx - gmx);
  float gden = den * w0;
  for (int c = 1; c < live_splits; ++c)
    gden = fmaf(recv_ml[c - 1][1], exp2f(recv_ml[c - 1][0] - gmx), gden);
  float* orow = out + (static_cast<int64_t>(slot) * heads + head) * D;
#pragma unroll
  for (int k = 0; k < kColsPerThread; ++k) {
    const int col = t + k * kThreads;
    if (col >= D) continue;
    float x = num[k] * w0;
    for (int c = 1; c < live_splits; ++c)
      x = fmaf(recv_acc[c - 1][col], exp2f(recv_ml[c - 1][0] - gmx), x);
    orow[col] = x / fmaxf(gden, 1e-30f);
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* tables;
  const int* lengths;
  float* out;
  int slots, heads, block_size, width, num_blocks;
  int64_t q_ss, q_sh;
  float scale;
  cudaStream_t stream;
};

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, found through the runtime (no
// link against the driver library), or null.
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// One layer's pages [num_blocks, block_size, heads, D] as a 4-D tensor
// map (innermost first) with box [1, rows, 1, D]; rows past block_size
// read as zeros.
template <typename TKV, int D>
int page_map(CUtensorMap* map, const void* pages, const Args& a, int rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  constexpr cuuint64_t kItem = sizeof(TKV);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(a.heads),
                              static_cast<cuuint64_t>(a.block_size),
                              static_cast<cuuint64_t>(a.num_blocks)};
  const cuuint64_t strides[3] = {D * kItem, a.heads * D * kItem,
                                 a.block_size * a.heads * D * kItem};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(D), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, sizeof(TKV) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                            : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      4, const_cast<void*>(pages), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

constexpr int round_up(int x, int to) { return (x + to - 1) / to * to; }

// Launch the (TQ, TKV, D) kernel; or, when info is not null, only say
// what that launch would get (see dmt_paged_attention_occupancy).
template <typename TQ, typename TKV, int D>
int launch(const Args& a, int* info) {
  using G = Geometry<TKV, D>;
  const int pages = (a.width + kSplits - 1) / kSplits;  // entries a block
  const int chunk_rows =
      std::min({a.block_size, 256, kMaxStageBytes / 2 / G::kRowBytes});
  const int per_page = (a.block_size + chunk_rows - 1) / chunk_rows;
  const int stage_bytes = 2 * round_up(chunk_rows * G::kRowBytes, 128);
  const int stages = std::min(
      {kMaxStages, pages * per_page, kMaxRingBytes / stage_bytes});
  // the groups' states reuse the ring at the end
  const int ring_bytes = std::max(stages * stage_bytes,
                                  round_up((D + 2) * G::kGroups * 4, 128));
  const size_t smem = ring_bytes + round_up(pages * 4, 16);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = paged_split_kernel<TQ, TKV, D>;
  // dynamic plus static shared memory may pass 48 KB: allow the most,
  // once per instantiation
  static const cudaError_t allowed = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (allowed != cudaSuccess) return static_cast<int>(allowed);
  const dim3 grid(kSplits, a.heads, a.slots);
  if (info == nullptr) {
    CUtensorMap k_map, v_map;
    int err = page_map<TKV, D>(&k_map, a.k, a, chunk_rows);
    if (err == 0) err = page_map<TKV, D>(&v_map, a.v, a, chunk_rows);
    if (err != 0) return err;
    kernel<<<grid, kThreads, smem, a.stream>>>(
        k_map, v_map, static_cast<const TQ*>(a.q), a.tables, a.lengths,
        a.out, a.heads, a.block_size, a.width, pages * a.block_size,
        chunk_rows, stages, stage_bytes, ring_bytes, a.q_ss, a.q_sh,
        a.scale);
    return static_cast<int>(cudaGetLastError());
  }
  info[1] = kThreads;
  info[2] = static_cast<int>(smem);
  info[3] = kSplits;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &info[0], kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(&info[4], kernel, &cfg));
}

template <typename TQ, typename TKV>
int dispatch_d(const Args& a, int d, int* info) {
  switch (d) {
    case 32: return launch<TQ, TKV, 32>(a, info);
    case 64: return launch<TQ, TKV, 64>(a, info);
    case 128: return launch<TQ, TKV, 128>(a, info);
    case 256: return launch<TQ, TKV, 256>(a, info);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename TQ>
int dispatch_kv(const Args& a, int kv_dtype, int d, int* info) {
  if (kv_dtype == 0) return dispatch_d<TQ, float>(a, d, info);
  if (kv_dtype == 1) return dispatch_d<TQ, __nv_bfloat16>(a, d, info);
  return static_cast<int>(cudaErrorInvalidValue);
}

int paged(const Args& a, int q_dtype, int kv_dtype, int d, int* info) {
  if (a.slots <= 0 || a.heads <= 0) return 0;
  if (a.slots > 65535 || a.heads > 65535 || a.block_size <= 0 ||
      a.width <= 0 || a.num_blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // the TMA reads from 16-byte aligned page bases
  if (reinterpret_cast<uintptr_t>(a.k) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(a.v) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (q_dtype == 0) return dispatch_kv<float>(a, kv_dtype, d, info);
  if (q_dtype == 1) return dispatch_kv<__nv_bfloat16>(a, kv_dtype, d, info);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtypes: 0 = float32, 1 = bfloat16. q [slots, heads, d] with element
// strides (q_ss, q_sh) and a contiguous last dim; k/v pages contiguous
// [num_blocks, block_size, heads, d] with 16-byte aligned bases; tables
// [slots, width] and lengths [slots] contiguous int32; out contiguous
// float32 [slots, heads, d]. Returns cudaGetLastError() after the launch
// (0 on success).
extern "C" int dmt_paged_attention(const void* q, const void* k_pages,
                                   const void* v_pages, const void* tables,
                                   const void* lengths, void* out,
                                   int q_dtype, int kv_dtype, int slots,
                                   int heads, int d, int block_size,
                                   int width, int num_blocks, int64_t q_ss,
                                   int64_t q_sh, float scale, void* stream) {
  const Args a{q, k_pages, v_pages, static_cast<const int*>(tables),
               static_cast<const int*>(lengths), static_cast<float*>(out),
               slots, heads, block_size, width, num_blocks, q_ss, q_sh, scale,
               static_cast<cudaStream_t>(stream)};
  return paged(a, q_dtype, kv_dtype, d, nullptr);
}

// Which kernel dmt_paged_attention launches for (q dtype, d): 0 the
// cluster-split kernel (every supported pair), -1 none.
extern "C" int dmt_paged_attention_route(int dtype, int d) {
  const bool ok_d = d == 32 || d == 64 || d == 128 || d == 256;
  return ok_d && (dtype == 0 || dtype == 1) ? 0 : -1;
}

// What a call would launch, without launching it: info[0..4] = blocks
// resident per SM, threads a block, dynamic shared memory bytes, blocks
// a cluster, clusters resident on the card at once. Returns a CUDA error
// code (0 on success).
extern "C" int dmt_paged_attention_occupancy(int q_dtype, int kv_dtype,
                                             int slots, int heads, int d,
                                             int block_size, int width,
                                             int* info) {
  const void* aligned = reinterpret_cast<const void*>(16);  // never read
  const Args a{nullptr, aligned, aligned, nullptr, nullptr, nullptr,
               slots, heads, block_size, width, 1, 0, 0, 1.f, nullptr};
  return paged(a, q_dtype, kv_dtype, d, info);
}
