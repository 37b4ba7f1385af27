// Factorized (hi/lo) gradient histogram for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fact_kernel` (h2o3_tpu/ops/pallas_histogram.py:243,
// launched from `_build_histogram_factorized` :285). Both compute, for every
// node of one tree level in one pass, the histogram
//     out[k, f, b, :] = sum over rows r with node[r] == k and bin[f, r] == b
//                       of (g[r], h[r], rw[r] or 1)
// with node[r] = -1 marking an inactive row. The TPU kernel splits each bin
// as b = hi * 16 + lo and writes the histogram as one contraction over rows,
// Ihi [HI, R] x U [(k, c, lo), R] -> [HI, K*C*16], so that it materializes
// (HI + K*C*16) one-hot entries per row instead of B1 (a win for its vector
// unit while K is small). Ihi and Ilo are one-hot, so each row adds its
// (g, h, w) at exactly one cell; here that add is done directly, once per
// active row and feature. (The contraction on the tensor cores would cost
// 2 * HI * K * 3 * 16 operations per row and feature where 3 adds are
// needed: 7.3e11 at 2M rows x 28 features, 257 bins, 8 nodes.)
//
// Pass 1 is one of two kernels (ops/cuda_factorized_histogram.py
// launch_plan); in both a block takes one row chunk and a group of
// features, one warp each, and one warp owns each cell of its feature:
//
//   fact_direct_kernel, while an SM holds more than 8 of its warps (up to 5
//     nodes at 257 bins, every level at 21; 4 features a block): each warp
//     keeps its feature's [HI, K, 3, 16] float slab in shared memory, the
//     TPU kernel's layout, reads its own rows (node, code, g, h, rw) from
//     memory, 4 32-row batches in flight, and adds them a batch at a time,
//     one row per lane.
//   fact_staged_kernel, for wider levels, where too few warps share an SM
//     to hide their own loads: each consumer warp keeps a [K, 3, B1]
//     histogram (smaller than the slab at 257 bins). One producer warp
//     stages the chunk R rows at a time in a ring of kStages buffers in
//     shared memory (node, g, h, rw with cp.async, 16 bytes a copy where the
//     source is aligned), rounds the values once for the bf16 mode, and
//     compacts each stage once: the stage-relative indices of its active
//     rows (0 <= node < K) in row order, cut into packs of whole 32-row
//     batches with at most 32 rows each, which every consumer warp of the
//     block shares. Each consumer copies its own feature's codes into the
//     stage (no other warp reads them), so every input byte is read from
//     memory once per block and the consumers never wait on device memory.
//     Named barriers hand a stage to the consumers (FULL) and back (EMPTY).
//     A consumer takes kPacksPerStep packs a step: their rows, read while
//     the step before is added, and their peers together, so those
//     latencies overlap; then each pack's adds in row order. It writes its
//     [K, 3, B1] histogram at the start of its (chunk, feature) slot of
//     the partials, a slab's size.
//
// In both, lanes whose rows fall in one (node, bin) cell find each other
// with __match_any_sync, and the lowest such lane walks them in lane (row)
// order, sums each batch's values from 0 and adds each batch's sum into the
// cell in turn, and alone writes the cell. No atomics, no float reordering.
//   pass 2 (fact_reduce_kernel, one instantiation per pass-1 layout): one
//     thread per cell adds the chunk partials in chunk order, in double,
//     and writes [K, F, B1, 3] float.
//
// The float order is the node-matmul kernel's (hist_nodematmul.cu): the row
// chunks of ops/cuda_histogram.py row_chunks; in a chunk, each aligned
// 32-row batch's rows of a cell summed from 0 in row order, the batch sums
// added to the cell in row order, in float; the chunk partials added in
// double in chunk order. A pack holds whole batches (a batch has at most 32
// rows), so no batch sum is cut in two. So either pass-1 kernel gives
// hist_nodematmul's bits on every level both serve, in both operand modes
// (the bf16 one rounds each value where it is loaded or staged,
// hist_operand.cuh), and the same call on the same inputs gives the same
// bits; counts (sums of 1 without rw) are exact integers and a node with no
// rows is exactly zero. ops/cuda_histogram.py hist_chunked_ordered_reference
// is that order in plain PyTorch.
//
// Bound on this card: memory. A call must read each row's node and, for an
// active row, its F bin codes and g, h (and rw): about N (4F + 16) bytes,
// ~250 MB at N = 2M, F = 28, i.e. ~75 us at 3.35 TB/s; the adds (3 per
// active row and feature) are negligible. What bounds both kernels is the
// per-batch (or per-pack) step: the peer search and the leader's
// read-modify-write of three cells, a chain of dependent shared-memory
// operations per 32 rows and feature; __match_any_sync is about a third of
// the staged kernel's time at 257 bins x 8 nodes. A block that fills an SM's
// shared memory holds 7 of those chains at 257 x 8 (24.7 KB a histogram),
// and the 76 row chunks x 4 feature groups fill the 132 SMs 2.3 times
// over, in three rounds.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hist_operand.cuh"

namespace {

constexpr int kWarp = 32;
constexpr unsigned kAll = 0xffffffffu;
constexpr int kLo = 16;     // _FACT_LO: bin = hi * kLo + lo
constexpr int kUnroll = 4;  // fact_direct_kernel: batches loaded together
// most features a block takes, one warp each (_MAX_GROUP)
constexpr int kMaxGroup = 8;
// fact_staged_kernel: staged row groups in the ring (_STAGES), most rows a
// stage holds (_STAGE_ROWS[0]) and so most 32-row batches, and packs a
// consumer takes in one step (_PACKS_PER_STEP)
constexpr int kStages = 4;
constexpr int kMaxStageRows = 256;
constexpr int kMaxBatches = kMaxStageRows / 32;
constexpr int kPacksPerStep = 4;

__host__ __device__ constexpr int round4(int words) { return (words + 3) & ~3; }

// 32-bit words of one warp's [HI, K, 3, 16] slab.
__host__ __device__ int slab_words(int n_nodes, int n_bins1) {
  return (n_bins1 + kLo - 1) / kLo * n_nodes * 3 * kLo;
}

// 32-bit words of one staged consumer's [K, 3, B1] histogram (_smem_bytes).
__host__ __device__ int hist_words(int n_nodes, int n_bins1) {
  return round4(n_nodes * 3 * n_bins1);
}

// 32-bit words of one stage of the staged kernel (_stage_words): node, g,
// h, rw, the group's codes, then the packed row list (uint16
// stage-relative indices) and the pack table (n_packs, then n_packs + 1
// offsets into the list), rounded to 16 bytes.
__host__ __device__ int stage_words(int group, int rows) {
  return round4((4 + group) * rows + rows / 2 + rows / kWarp + 2);
}

// Dynamic shared memory bytes one block needs (_smem_bytes): the direct
// kernel's warps' slabs and [3, 32] lane scratch, or the staged kernel's
// consumers' histograms and its ring of stages.
int smem_bytes(int n_nodes, int n_bins1, int group, int rows, bool staged) {
  if (!staged) return 4 * group * (slab_words(n_nodes, n_bins1) + 3 * kWarp);
  return 4 * (group * hist_words(n_nodes, n_bins1) + kStages * stage_words(group, rows));
}

// ---------------------------------------------------------------------------
// the direct kernel: each warp reads its own rows

template <bool kBf16>
__global__ void fact_direct_kernel(
    const int32_t* __restrict__ bins_fm,  // [F, N]
    const int32_t* __restrict__ nodes,    // [N]
    const float* __restrict__ g,          // [N]
    const float* __restrict__ h,          // [N]
    const float* __restrict__ rw,         // [N] or nullptr
    float* __restrict__ partial,          // [n_chunks, F, HI, K, 3, kLo]
    int n_rows, int n_feat, int n_nodes, int n_bins1, int group,
    int chunk_rows) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int f = blockIdx.x * group + warp;
  const int slab_size = slab_words(n_nodes, n_bins1);
  // this warp's slab [HI, K, 3, kLo] and its lane scratch [3, 32]
  float* acc = reinterpret_cast<float*>(smem) + (size_t)warp * (slab_size + 3 * kWarp);
  float* scratch = acc + slab_size;
  if (f >= n_feat) return;  // no block-wide barrier below: safe to leave

  for (int i = lane; i < slab_size; i += kWarp) acc[i] = 0.0f;
  __syncwarp();

  const long long row_begin = (long long)blockIdx.y * chunk_rows;
  const long long row_end = min((long long)n_rows, row_begin + chunk_rows);
  const int32_t* codes = bins_fm + (long long)f * n_rows;

  for (long long r0 = row_begin; r0 < row_end; r0 += kWarp * kUnroll) {
    // start every load of kUnroll batches before the first is used
    int nd[kUnroll], code[kUnroll];
    float vg[kUnroll], vh[kUnroll], vw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = r0 + u * kWarp + lane;
      nd[u] = -1;
      code[u] = 0;
      vg[u] = vh[u] = vw[u] = 0.f;
      if (r < row_end) {
        nd[u] = nodes[r];
        code[u] = codes[r];
        vg[u] = hist_operand<kBf16>(g[r]);
        vh[u] = hist_operand<kBf16>(h[r]);
        vw[u] = rw ? hist_operand<kBf16>(rw[r]) : 1.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      // (node, bin) cell of this lane's row; -1 = no row. Out-of-range
      // nodes or codes count as inactive: never write outside the slab.
      const bool live = nd[u] >= 0 && nd[u] < n_nodes && code[u] >= 0 &&
                        code[u] < n_bins1;
      const int key = live ? nd[u] * n_bins1 + code[u] : -1;
      const unsigned peers = __match_any_sync(kAll, key);
      scratch[lane] = vg[u];
      scratch[kWarp + lane] = vh[u];
      scratch[2 * kWarp + lane] = vw[u];
      __syncwarp();
      if (live && lane == __ffs(peers) - 1) {
        float sg = 0.f, sh = 0.f, sw = 0.f;
        for (unsigned m = peers; m; m &= m - 1) {  // peers in lane (row) order
          const int j = __ffs(m) - 1;
          sg += scratch[j];
          sh += scratch[kWarp + j];
          sw += scratch[2 * kWarp + j];
        }
        float* c = acc + ((size_t)(code[u] / kLo) * n_nodes + nd[u]) * 3 * kLo +
                   code[u] % kLo;
        c[0] += sg;
        c[kLo] += sh;
        c[2 * kLo] += sw;
      }
      __syncwarp();  // scratch and cells settled before the next batch
    }
  }
  float* dst = partial + ((size_t)blockIdx.y * n_feat + f) * slab_size;
  for (int i = lane; i < slab_size; i += kWarp) dst[i] = acc[i];
}

// ---------------------------------------------------------------------------
// the staged kernel: a block stages its rows once

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// this thread's copies of all but the `kPending` newest groups landed
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// One warp starts copying n 32-bit words from src to dst (16-byte
// aligned): 16 bytes a copy where src is 16-byte aligned too, else 4.
__device__ void stage_array(void* dst, const void* src, int n, int lane) {
  uint32_t* d = static_cast<uint32_t*>(dst);
  const uint32_t* from = static_cast<const uint32_t*>(src);
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(from) & 15) == 0) {
    done = n & ~3;
    for (int i = lane * 4; i < done; i += 4 * kWarp) cp_async16(d + i, from + i);
  }
  for (int i = done + lane; i < n; i += kWarp) cp_async4(d + i, from + i);
}

// Named barriers 1 .. kStages hand stage buffer b to the consumers (FULL),
// kStages + 1 .. 2 kStages hand it back (EMPTY); barrier 0 is
// __syncthreads'. Every warp of the block takes part in each.
__device__ __forceinline__ int full_bar(int buf) { return 1 + buf; }
__device__ __forceinline__ int empty_bar(int buf) { return 1 + kStages + buf; }

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

struct Stage {
  int* node;
  float* g;
  float* h;
  float* w;
  int* codes;     // [group, rows]
  uint16_t* idx;  // [rows] packed active rows, stage-relative
  int* packs;     // [0]: n_packs; [1 + p]: first index of pack p
};

__device__ __forceinline__ Stage stage_at(uint32_t* ring, int buf, int group, int rows) {
  uint32_t* base = ring + (size_t)buf * stage_words(group, rows);
  Stage s;
  s.node = reinterpret_cast<int*>(base);
  s.g = reinterpret_cast<float*>(base + rows);
  s.h = reinterpret_cast<float*>(base + 2 * rows);
  s.w = reinterpret_cast<float*>(base + 3 * rows);
  s.codes = reinterpret_cast<int*>(base + 4 * rows);
  s.idx = reinterpret_cast<uint16_t*>(base + (4 + group) * rows);
  s.packs = reinterpret_cast<int*>(base + (4 + group) * rows + rows / 2);
  return s;
}

// The producer: compact the first n_valid rows of stage s. Packs take whole
// 32-row batches, in row order, while their active rows fit 32 lanes.
__device__ void compact(const Stage& s, int n_valid, int n_nodes, int lane) {
  unsigned act[kMaxBatches];
#pragma unroll
  for (int b = 0; b < kMaxBatches; ++b) {  // every batch's loads in flight together
    const int i = b * kWarp + lane;
    const int nd = i < n_valid ? s.node[i] : -1;
    act[b] = __ballot_sync(kAll, (unsigned)nd < (unsigned)n_nodes);
  }
  const unsigned below = (1u << lane) - 1;
  int n = 0, n_packs = 0, fill = 0;
#pragma unroll
  for (int b = 0; b < kMaxBatches; ++b) {
    const int c = __popc(act[b]);
    if (c && fill + c > kWarp) {  // close the open pack; this batch opens the next
      ++n_packs;
      if (lane == 0) s.packs[1 + n_packs] = n;
      fill = 0;
    }
    if (act[b] >> lane & 1) s.idx[n + __popc(act[b] & below)] = (uint16_t)(b * kWarp + lane);
    fill += c;
    n += c;
  }
  if (fill) ++n_packs;
  if (lane == 0) {
    s.packs[0] = n_packs;
    s.packs[1] = 0;
    s.packs[1 + n_packs] = n;
  }
}

// One pack's rows as its lanes hold them.
struct PackRows {
  int lo;    // the pack's first index in the stage's list
  int i;     // the lane's stage-relative row
  int key;   // its cell: node * B1 + bin
  int cell;  // that cell's channel 0 in the [K, 3, B1] histogram
  bool live;
  float g, h, w;
};

__device__ __forceinline__ PackRows load_pack(const Stage& s, const int* code_row,
                                              int p, int n_packs, bool has_rw,
                                              int n_bins1, int lane) {
  PackRows r;
  r.lo = p < n_packs ? s.packs[1 + p] : 0;
  const int j = r.lo + lane;
  const bool in = p < n_packs && j < s.packs[2 + p];
  r.i = in ? s.idx[j] : 0;
  const int nd = s.node[r.i];
  const int code = code_row[r.i];
  // a packed row's node is in range; an out-of-range code is no row
  r.live = in && (unsigned)code < (unsigned)n_bins1;
  r.key = nd * n_bins1 + code;
  r.cell = nd * 3 * n_bins1 + code;
  r.g = s.g[r.i];
  r.h = s.h[r.i];
  r.w = has_rw ? s.w[r.i] : 1.0f;
  return r;
}

// The lowest lane of each cell in pack r walks its cell's lanes `peers` in
// lane (row) order, sums each batch's values from 0 and adds each batch's
// sum into the cell in turn.
__device__ __forceinline__ void add_pack(float* acc, const Stage& s, const PackRows& r,
                                         unsigned peers, bool has_rw, int n_bins1,
                                         int lane) {
  if (!(r.live && lane == __ffs(peers) - 1)) return;
  float* c = acc + r.cell;
  float cg = c[0], ch = c[n_bins1], cw = c[2 * n_bins1];
  float sg = 0.f, sh = 0.f, sw = 0.f;
  sg += r.g;
  sh += r.h;
  sw += r.w;
  int batch = r.i / kWarp;
  for (unsigned m = peers & (peers - 1); m; m &= m - 1) {
    const int ii = s.idx[r.lo + __ffs(m) - 1];
    if (ii / kWarp != batch) {  // the same cell, a later batch
      cg += sg;
      ch += sh;
      cw += sw;
      sg = sh = sw = 0.f;
      batch = ii / kWarp;
    }
    sg += s.g[ii];
    sh += s.h[ii];
    sw += has_rw ? s.w[ii] : 1.0f;
  }
  c[0] = cg + sg;
  c[n_bins1] = ch + sh;
  c[2 * n_bins1] = cw + sw;
}

// One consumer adds stage s's packs into its histogram `acc` [K, 3, B1];
// `code_row` is its feature's staged code row. It takes kPacksPerStep
// packs a step: their rows (read while the step before is added) and their
// peers together, so the latencies overlap; then each pack's adds in pack
// (row) order.
__device__ void add_stage(float* acc, const Stage& s, const int* code_row,
                          bool has_rw, int n_bins1, int lane) {
  const int n_packs = s.packs[0];
  PackRows next[kPacksPerStep];
#pragma unroll
  for (int q = 0; q < kPacksPerStep; ++q)
    next[q] = load_pack(s, code_row, q, n_packs, has_rw, n_bins1, lane);
  for (int p0 = 0; p0 < n_packs; p0 += kPacksPerStep) {
    PackRows r[kPacksPerStep];
    unsigned peers[kPacksPerStep];
#pragma unroll
    for (int q = 0; q < kPacksPerStep; ++q) r[q] = next[q];
    if (p0 + kPacksPerStep < n_packs) {
#pragma unroll
      for (int q = 0; q < kPacksPerStep; ++q)
        next[q] = load_pack(s, code_row, p0 + kPacksPerStep + q, n_packs, has_rw,
                            n_bins1, lane);
    }
#pragma unroll
    for (int q = 0; q < kPacksPerStep; ++q)
      peers[q] = __match_any_sync(kAll, r[q].live ? r[q].key : -1);
#pragma unroll
    for (int q = 0; q < kPacksPerStep; ++q) {
      add_pack(acc, s, r[q], peers[q], has_rw, n_bins1, lane);
      __syncwarp();  // the cells settled before the next pack
    }
  }
}

template <bool kBf16>
__global__ void __launch_bounds__((kMaxGroup + 1) * kWarp) fact_staged_kernel(
    const int32_t* __restrict__ bins_fm,  // [F, N]
    const int32_t* __restrict__ nodes,    // [N]
    const float* __restrict__ g,          // [N]
    const float* __restrict__ h,          // [N]
    const float* __restrict__ rw,         // [N] or nullptr
    float* __restrict__ partial,          // [n_chunks, F, HI, K, 3, kLo]
    int n_rows, int n_feat, int n_nodes, int n_bins1, int group, int chunk_rows,
    int rows) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int threads = blockDim.x;  // (group + 1) warps
  const int hist_size = n_nodes * 3 * n_bins1;
  float* hists = reinterpret_cast<float*>(smem);
  uint32_t* ring = smem + (size_t)group * hist_words(n_nodes, n_bins1);

  const int f_lo = blockIdx.x * group;
  const int n_mine = min(group, n_feat - f_lo);
  const long long row_begin = (long long)blockIdx.y * chunk_rows;
  const long long row_end = min((long long)n_rows, row_begin + chunk_rows);
  const int n_stages = (int)((row_end - row_begin + rows - 1) / rows);
  // stage t: its first row and its rows
  auto first_row = [&](int t) { return row_begin + (long long)t * rows; };
  auto valid_rows = [&](int t) { return (int)min((long long)rows, row_end - first_row(t)); };

  if (warp == group) {  // the producer
    auto start_copies = [&](int t) {
      const Stage s = stage_at(ring, t % kStages, group, rows);
      const long long r0 = first_row(t);
      const int n = valid_rows(t);
      stage_array(s.node, nodes + r0, n, lane);
      stage_array(s.g, g + r0, n, lane);
      stage_array(s.h, h + r0, n, lane);
      if (rw) stage_array(s.w, rw + r0, n, lane);
    };
    // one commit group per stage: when stage t is compacted, t + 1 groups,
    // and kStages - 2 more, have been committed
    for (int t = 0; t < kStages - 1; ++t) {
      if (t < n_stages) start_copies(t);
      cp_async_commit();
    }
    for (int t = 0; t < n_stages; ++t) {
      cp_async_wait<kStages - 2>();
      __syncwarp();  // every lane's copies of stage t landed
      const Stage s = stage_at(ring, t % kStages, group, rows);
      const int n = valid_rows(t);
      if (kBf16) {  // round the staged values once, in place
        for (int i = lane; i < n; i += kWarp) {
          s.g[i] = hist_operand<kBf16>(s.g[i]);
          s.h[i] = hist_operand<kBf16>(s.h[i]);
          if (rw) s.w[i] = hist_operand<kBf16>(s.w[i]);
        }
        __syncwarp();
      }
      compact(s, n, n_nodes, lane);
      __syncwarp();
      bar_arrive(full_bar(t % kStages), threads);
      // refill the buffer of stage t - 1 with stage t + kStages - 1 once
      // the consumers have handed it back
      const int next = t + kStages - 1;
      if (next < n_stages) {
        if (t >= 1) bar_sync(empty_bar((t - 1) % kStages), threads);
        start_copies(next);
      }
      cp_async_commit();
    }
    return;
  }

  // a consumer; one without a feature (the last group may be short) still
  // takes part in every barrier
  const bool mine = warp < n_mine;
  float* acc = hists + (size_t)warp * hist_words(n_nodes, n_bins1);
  const int32_t* codes = bins_fm + (long long)(f_lo + warp) * n_rows;
  // its codes of stage t, into its own row of the stage's buffer
  auto copy_codes = [&](int t) {
    const Stage s = stage_at(ring, t % kStages, group, rows);
    stage_array(s.codes + warp * rows, codes + first_row(t), valid_rows(t), lane);
  };
  if (mine) {
    for (int i = lane; i < hist_size; i += kWarp) acc[i] = 0.0f;
    // one commit group per stage: when stage t is added, t + 1 groups,
    // and kStages - 1 more, have been committed
    for (int t = 0; t < kStages; ++t) {
      if (t < n_stages) copy_codes(t);
      cp_async_commit();
    }
  }
  __syncwarp();
  for (int t = 0; t < n_stages; ++t) {
    bar_sync(full_bar(t % kStages), threads);
    if (mine) {
      cp_async_wait<kStages - 1>();
      __syncwarp();  // every lane's copies of this stage's codes landed
      const Stage s = stage_at(ring, t % kStages, group, rows);
      add_stage(acc, s, s.codes + warp * rows, rw != nullptr, n_bins1, lane);
      // its own code row of this buffer is free: the codes of stage
      // t + kStages go there
      __syncwarp();
      if (t + kStages < n_stages) copy_codes(t + kStages);
      cp_async_commit();
    }
    if (t + kStages < n_stages) bar_arrive(empty_bar(t % kStages), threads);
  }
  if (!mine) return;
  // the histogram [K, 3, B1] at the start of this feature's slot
  float* dst = partial + ((size_t)blockIdx.y * n_feat + f_lo + warp) *
                             slab_words(n_nodes, n_bins1);
  for (int i = lane; i < hist_size; i += kWarp) dst[i] = acc[i];
}

// ---------------------------------------------------------------------------

// kSlab: the partials are the direct kernel's [HI, K, 3, kLo] slabs, else
// the staged kernel's [K, 3, B1] histograms; each thread reads its cell's
// partials from one feature slot (slab_words floats) of each chunk.
template <bool kSlab>
__global__ void fact_reduce_kernel(
    const float* __restrict__ partial,  // [n_chunks, F, HI * K * 3 * kLo]
    float* __restrict__ out,            // [K, F, B1, 3]
    int n_chunks, int n_feat, int n_nodes, int n_bins1) {
  const long long cells = (long long)n_nodes * n_feat * n_bins1 * 3;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cells) return;
  const int slot = slab_words(n_nodes, n_bins1);
  const long long per_chunk = (long long)n_feat * slot;
  long long src, dst;
  if (kSlab) {  // one thread per output cell, in output order
    const int ch = (int)(i % 3);
    long long q = i / 3;
    const int b = (int)(q % n_bins1);
    q /= n_bins1;
    const int f = (int)(q % n_feat);
    const int k = (int)(q / n_feat);
    src = (((long long)f * (slot / (n_nodes * 3 * kLo)) + b / kLo) * n_nodes * 3 + k * 3 + ch) *
              kLo + b % kLo;
    dst = i;
  } else {  // one thread per histogram cell, in histogram order
    const int b = (int)(i % n_bins1);
    long long q = i / n_bins1;
    const int ch = (int)(q % 3);
    q /= 3;
    const int k = (int)(q % n_nodes);
    const int f = (int)(q / n_nodes);
    src = (long long)f * slot + ((long long)k * 3 + ch) * n_bins1 + b;
    dst = (((long long)k * n_feat + f) * n_bins1 + b) * 3 + ch;
  }
  double s = 0.0;
  for (int c = 0; c < n_chunks; ++c) s += (double)partial[c * per_chunk + src];
  out[dst] = (float)s;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// Pass 1 of one call in operand mode kBf16: the staged kernel or the
// direct one.
template <bool kBf16>
cudaError_t launch_partial(
    const int32_t* bins_fm, const int32_t* nodes, const float* g,
    const float* h, const float* rw, float* partial, int n_rows, int n_feat,
    int n_nodes, int n_bins1, int group, int chunk_rows, int n_chunks,
    int rows, int staged, cudaStream_t s) {
  const int smem = smem_bytes(n_nodes, n_bins1, group, rows, staged);
  const dim3 grid((n_feat + group - 1) / group, n_chunks);
  cudaError_t err;
  if (!staged) {
    err = allow_smem(fact_direct_kernel<kBf16>, smem);
    if (err != cudaSuccess) return err;
    fact_direct_kernel<kBf16><<<grid, group * kWarp, smem, s>>>(
        bins_fm, nodes, g, h, rw, partial, n_rows, n_feat, n_nodes, n_bins1, group,
        chunk_rows);
  } else {
    err = allow_smem(fact_staged_kernel<kBf16>, smem);
    if (err != cudaSuccess) return err;
    fact_staged_kernel<kBf16><<<grid, (group + 1) * kWarp, smem, s>>>(
        bins_fm, nodes, g, h, rw, partial, n_rows, n_feat, n_nodes, n_bins1, group,
        chunk_rows, rows);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches both passes on `stream`; returns the CUDA error code (0 = ok;
// cudaErrorInvalidValue for a plan outside the kernels' domain). The caller
// allocates `partial` ([n_chunks, F, HI * K * 3 * 16] float, HI = ceil(B1
// / 16)) and `out` ([K, F, B1, 3] float), has validated shapes and types, and
// gives the launch plan (ops/cuda_factorized_histogram.py launch_plan):
// `group` features a block, the row chunks, and whether pass 1 is the
// staged kernel, with `rows` rows a stage (a multiple of 32, at most 256).
// bf16 1 rounds the values to bf16 operands (hist_operand.cuh), 0 reads
// them as float32.
int hist_factorized_launch(
    const int32_t* bins_fm, const int32_t* nodes, const float* g,
    const float* h, const float* rw, float* partial, float* out,
    int n_rows, int n_feat, int n_nodes, int n_bins1, int group,
    int chunk_rows, int n_chunks, int rows, int staged, int bf16,
    void* stream) {
  if (group < 1 || group > kMaxGroup || chunk_rows % kWarp ||
      (staged && (rows < kWarp || rows > kMaxStageRows || rows % kWarp)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = (bf16 ? launch_partial<true> : launch_partial<false>)(
      bins_fm, nodes, g, h, rw, partial, n_rows, n_feat, n_nodes, n_bins1,
      group, chunk_rows, n_chunks, rows, staged, s);
  if (err != cudaSuccess) return (int)err;
  const long long cells = (long long)n_feat * n_nodes * 3 * n_bins1;
  const int rt = 256;
  (staged ? fact_reduce_kernel<false> : fact_reduce_kernel<true>)
      <<<(unsigned)((cells + rt - 1) / rt), rt, 0, s>>>(partial, out, n_chunks, n_feat,
                                                        n_nodes, n_bins1);
  return (int)cudaGetLastError();
}

const char* hist_factorized_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
