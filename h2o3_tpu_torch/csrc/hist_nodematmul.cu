// Node-batched gradient histogram for Hopper (sm_90a).
//
// Replaces the TPU kernel `_nm_kernel` (h2o3_tpu/ops/pallas_histogram.py:94,
// launched from `_build_histogram_nodematmul` :162). Both compute, for every
// node of one tree level in one pass, the histogram
//     out[k, f, b, :] = sum over rows r with node[r] == k and bin[f, r] == b
//                       of (g[r], h[r], rw[r] or 1)
// with node[r] = -1 marking an inactive row. The TPU kernel writes it as a
// contraction over rows on the matrix unit: a one-hot of the bin codes times
// the node-masked values, B1 multiply-adds per row where one add is needed.
// That trade only pays on the TPU's matrix unit; here each row is added once.
//
// One feature's [K, 3, B1] float histogram is cut into tiles of node_tile
// nodes x bin_tile bins (ops/cuda_histogram.py cell_tiles). Every (feature,
// tile) is a slot; warp w of block x owns slot x * warps_per_block + w, so
// each cell of the histogram belongs to exactly one warp, which keeps its
// tile in shared memory. Every tile's warp walks all of its feature's rows,
// so fewer tiles mean less work, but the walks are latency-bound and two
// blocks on an SM run more than twice as fast as one: the plan takes one
// tile per feature where two blocks of whole histograms share an SM (K x B1
// <= 1,173 cells: the root, 4 nodes at 257 bins, 32 at 21), else the
// fewest tiles that let two blocks share an SM unless one block an SM needs
// under half as many (16 nodes at 257 bins: 6 tiles of 3 nodes; 64 at 257:
// 8 tiles of 8; past about 2,000 bins a tile is one node's bin range). Pass
// 1 is one of two kernels, by the tile count:
//
//   hist_warp_kernel, one tile per feature: the block's warps take
//     neighbouring features of one row chunk. A warp walks the chunk 32 rows
//     at a time, one row per lane, loading from memory with kUnroll batches
//     in flight.
//   hist_tile_kernel, more tiles: the block's warps take the tiles of one or
//     a few features of one row chunk. The block stages the chunk 512 rows
//     at a time in shared memory (node, g, h, rw and the codes of its
//     features), double-buffered with cp.async, so each input byte is read
//     from memory once per block, not once per warp. A warp walks the staged
//     rows 32 at a time and moves the rows of its tile, in row order, into
//     its pack of 32; when the next batch's rows would not fit, it adds the
//     pack to its tile.
//
// In both, lanes whose rows fall in the same (node, bin) cell find each
// other with __match_any_sync and the lowest such lane adds them: no two
// lanes write one cell at once, and there are no atomics. A cell's sum is
// the same sequence of float adds in both kernels and at every tiling: each
// aligned 32-row batch's rows of the cell summed from 0 in row order, the
// batch sums added to the cell in row order (a pack holds whole batches'
// rows of its tile and its leader adds each batch's sum in turn), then
// pass 2 (hist_reduce_kernel, one thread per output cell) adds the chunk
// partials in chunk order in double and writes [K, F, B1, 3] float. So the
// same call on the same inputs gives bit-identical output, a level built for
// more (padded) nodes gives the same cells, and the factorized kernel
// (hist_factorized.cu: the same chunks, the same order in a cell) gives the
// same bits. The row chunks depend on the row and feature counts only
// (ops/cuda_histogram.py row_chunks). Counts (sum of 1 without rw) are exact
// integers. Each pass-1 kernel has a float32 and a bf16 instantiation
// (kBf16, hist_operand.cuh): the bf16 one rounds g, h and rw where it reads
// them (hist_warp_kernel from memory, hist_tile_kernel from the staged
// rows, so the staging copy is the same) and adds them in the same order.
//
// Bound on this card: memory. A call must read each row's node and, for an
// active row, its F bin codes and g, h (and rw): about N (4F + 16) bytes,
// ~250 MB at N = 2M, F = 28, i.e. ~75 us at 3.35 TB/s; the arithmetic (3
// adds per active row and feature) is negligible. What this kernel does
// about it: every bin code is read once, coalesced, and the histograms never
// leave shared memory until the end. What still costs: the walks are bound
// by instruction latency, not bytes (a warp's per-batch scan and a pack's
// match/leader step are a few dozen dependent instructions, with 8 to 24
// warps an SM to hide them); each tile's warp walks all of its feature's
// rows (8 walks of each row at 64 nodes x 257 bins); node, g and h are read
// once per block (from L2 when the chunk's other blocks brought them); and
// the chunk partials ([chunks, F, K, 3, B1] float) are written and read back
// once.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hist_operand.cuh"

namespace {

constexpr int kWarp = 32;
constexpr unsigned kAll = 0xffffffffu;
constexpr int kUnroll = 4;       // hist_warp_kernel: batches loaded together
constexpr int kGroupRows = 512;  // hist_tile_kernel: rows staged per step (_GROUP_ROWS)
constexpr int kGroupBatches = kGroupRows / kWarp;
// A pack entry is (cell << kBatchBits | batch, g, h, w): the cell's offset
// in the tile and the row's 32-row batch in its chunk (at most 1,024).
constexpr int kBatchBits = 10;

// Features whose bin codes one block of hist_tile_kernel stages: the slots
// of warps_per_block consecutive warps span at most this many features when
// each feature has `tiles` tiles (_staged_features in ops/cuda_histogram.py).
int staged_features(int warps_per_block, int tiles) {
  const int span = (warps_per_block - 1) / tiles + 2;
  return span < warps_per_block ? span : warps_per_block;
}

// 32-bit words of one staging buffer: node, g, h, rw, then the bin codes of
// each staged feature (_stage_words in ops/cuda_histogram.py).
int stage_words(int n_staged) { return kGroupRows * (4 + n_staged); }

// Dynamic shared memory bytes one block needs (mirrored by _block_bytes in
// ops/cuda_histogram.py). One tile per feature: each warp's [K, 3, B1]
// histogram and [3, 32] lane scratch. More: each warp's pack (32 x 4 words)
// and [node_tile, 3, bin_tile] tile, and two staging buffers.
int smem_bytes(int node_tile, int bin_tile, int tiles, int warps_per_block) {
  const int tile_size = node_tile * 3 * bin_tile;
  if (tiles == 1) return 4 * warps_per_block * (tile_size + 3 * kWarp);
  return 4 * (warps_per_block * (4 * kWarp + tile_size) +
              2 * stage_words(staged_features(warps_per_block, tiles)));
}

// ---------------------------------------------------------------------------
// one tile per feature

template <bool kBf16>
__global__ void hist_warp_kernel(
    const int32_t* __restrict__ bins_fm,  // [F, N]
    const int32_t* __restrict__ nodes,    // [N]
    const float* __restrict__ g,          // [N]
    const float* __restrict__ h,          // [N]
    const float* __restrict__ rw,         // [N] or nullptr
    float* __restrict__ partial,          // [n_chunks, F, K, 3, B1]
    int n_rows, int n_feat, int n_nodes, int n_bins1, int warps_per_block,
    int chunk_rows) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int f = blockIdx.x * warps_per_block + warp;
  const int hist_size = n_nodes * 3 * n_bins1;
  // this warp's histogram [K, 3, B1] and its lane scratch [3, 32]
  float* acc = smem + (size_t)warp * (hist_size + 3 * kWarp);
  float* scratch = acc + hist_size;
  if (f >= n_feat) return;  // no block-wide barrier below: safe to leave

  for (int i = lane; i < hist_size; i += kWarp) acc[i] = 0.0f;
  __syncwarp();

  const long long row_begin = (long long)blockIdx.y * chunk_rows;
  const long long row_end = min((long long)n_rows, row_begin + chunk_rows);
  const int32_t* codes = bins_fm + (long long)f * n_rows;

  for (long long r0 = row_begin; r0 < row_end; r0 += kWarp * kUnroll) {
    // issue every load of kUnroll batches before the first is used, so one
    // memory latency covers kUnroll batches
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
      // nodes or codes count as inactive: never write outside the cells.
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
        float* c = acc + (size_t)nd[u] * 3 * n_bins1 + code[u];
        c[0] += sg;
        c[n_bins1] += sh;
        c[2 * n_bins1] += sw;
      }
      __syncwarp();  // scratch and cells settled before the next batch
    }
  }
  float* dst = partial + ((size_t)blockIdx.y * n_feat + f) * hist_size;
  for (int i = lane; i < hist_size; i += kWarp) dst[i] = acc[i];
}

// ---------------------------------------------------------------------------
// more tiles per feature

// The cells of one slot (warp_tile in ops/cuda_histogram.py): feature
// slot / tiles; tile slot % tiles, whose node range is its quotient by the
// bin tiles and whose bin range is its remainder.
struct Tile {
  int f, k0, k1, b0, b1;
};

__device__ Tile warp_tile(int slot, int tiles, int bin_tiles, int node_tile,
                          int bin_tile, int n_nodes, int n_bins1) {
  Tile t;
  t.f = slot / tiles;
  const int i = slot % tiles;
  t.k0 = i / bin_tiles * node_tile;
  t.k1 = min(n_nodes, t.k0 + node_tile);
  t.b0 = i % bin_tiles * bin_tile;
  t.b1 = min(n_bins1, t.b0 + bin_tile);
  return t;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start the copies of rows [r0, min(r0 + kGroupRows, row_end)) into `buf`:
// node, g, h, rw (when given) and the codes of features f_lo .. f_lo +
// n_staged - 1. Rows past row_end are not copied, and never read.
__device__ void stage_rows(uint32_t* buf, long long r0, long long row_end,
                           const int32_t* bins_fm, const int32_t* nodes,
                           const float* g, const float* h, const float* rw,
                           int f_lo, int n_staged, int n_rows) {
  for (int i = threadIdx.x; i < kGroupRows && r0 + i < row_end; i += blockDim.x) {
    const long long r = r0 + i;
    cp_async4(buf + i, nodes + r);
    cp_async4(buf + kGroupRows + i, g + r);
    cp_async4(buf + 2 * kGroupRows + i, h + r);
    if (rw) cp_async4(buf + 3 * kGroupRows + i, rw + r);
    for (int j = 0; j < n_staged; ++j)
      cp_async4(buf + (4 + j) * kGroupRows + i,
                bins_fm + (long long)(f_lo + j) * n_rows + r);
  }
}

// Add the pack's n entries to the tile `acc`. Lanes whose entries share a
// cell find each other with __match_any_sync; the lowest such lane walks
// them in lane (row) order, sums each batch's values from 0 and adds each
// batch's sum into the cell in turn: the adds hist_warp_kernel makes.
__device__ void add_pack(float* acc, const int4* pack, int n, int bin_tile,
                         int lane) {
  __syncwarp();  // the pack's entries written by every lane
  const int4 e = pack[lane < n ? lane : 0];
  const int key = lane < n ? e.x >> kBatchBits : -1;
  const unsigned peers = __match_any_sync(kAll, key);
  if (key >= 0 && lane == __ffs(peers) - 1) {
    float* c = acc + key;
    float cg = c[0], ch = c[bin_tile], cw = c[2 * bin_tile];
    float sg = 0.f, sh = 0.f, sw = 0.f;
    int batch = e.x;
    for (unsigned m = peers; m; m &= m - 1) {  // peers in lane (row) order
      const int4 p = pack[__ffs(m) - 1];
      if (p.x != batch) {  // the same cell, a later batch
        cg += sg;
        ch += sh;
        cw += sw;
        sg = sh = sw = 0.f;
        batch = p.x;
      }
      sg += __int_as_float(p.y);
      sh += __int_as_float(p.z);
      sw += __int_as_float(p.w);
    }
    c[0] = cg + sg;
    c[bin_tile] = ch + sh;
    c[2 * bin_tile] = cw + sw;
  }
  __syncwarp();  // the cells and the pack settled before the next pack
}

// One warp takes the first n_valid staged rows of `buf` (batches batch0,
// batch0 + 1, ... of its chunk) and moves those that fall in its tile `t`
// into its pack, adding the pack to its tile `acc` whenever the next
// batch's rows would not fit. code_row is the staged code row of its
// feature; `n_pack` carries the pack's fill from group to group.
template <bool kBf16>
__device__ void add_staged(float* acc, int4* pack, int& n_pack,
                           const uint32_t* buf, int n_valid, int batch0,
                           const Tile& t, int code_row, int bin_tile,
                           bool has_rw, int lane) {
  const int* s_node = reinterpret_cast<const int*>(buf);
  const float* s_g = reinterpret_cast<const float*>(buf + kGroupRows);
  const float* s_h = reinterpret_cast<const float*>(buf + 2 * kGroupRows);
  const float* s_w = reinterpret_cast<const float*>(buf + 3 * kGroupRows);
  const int* s_code = reinterpret_cast<const int*>(buf + (4 + code_row) * kGroupRows);
  // every batch's rows first, their loads in flight together; then the
  // pack. Out-of-range nodes or codes lie in no tile: they count as inactive.
  int cell[kGroupBatches];
  unsigned ballot[kGroupBatches];
  float vg[kGroupBatches], vh[kGroupBatches], vw[kGroupBatches];
#pragma unroll
  for (int b = 0; b < kGroupBatches; ++b) {
    const int i = b * kWarp + lane;
    const int kl = s_node[i] - t.k0;
    const int bl = s_code[i] - t.b0;
    const bool mine = i < n_valid && (unsigned)kl < (unsigned)(t.k1 - t.k0) &&
                      (unsigned)bl < (unsigned)(t.b1 - t.b0);
    cell[b] = kl * 3 * bin_tile + bl;
    ballot[b] = __ballot_sync(kAll, mine);
    // read by every lane (no branch); kept by its own
    vg[b] = hist_operand<kBf16>(s_g[i]);
    vh[b] = hist_operand<kBf16>(s_h[i]);
    vw[b] = has_rw ? hist_operand<kBf16>(s_w[i]) : 1.0f;
  }
  const unsigned below = (1u << lane) - 1;
#pragma unroll
  for (int b = 0; b < kGroupBatches; ++b) {
    if (!ballot[b]) continue;  // warp-uniform
    const int cnt = __popc(ballot[b]);
    if (n_pack + cnt > kWarp) {
      add_pack(acc, pack, n_pack, bin_tile, lane);
      n_pack = 0;
    }
    if (ballot[b] >> lane & 1)
      pack[n_pack + __popc(ballot[b] & below)] =
          make_int4(cell[b] << kBatchBits | (batch0 + b), __float_as_int(vg[b]),
                    __float_as_int(vh[b]), __float_as_int(vw[b]));
    n_pack += cnt;
  }
}

template <bool kBf16>
__global__ void __launch_bounds__(8 * kWarp) hist_tile_kernel(
    const int32_t* __restrict__ bins_fm,  // [F, N]
    const int32_t* __restrict__ nodes,    // [N]
    const float* __restrict__ g,          // [N]
    const float* __restrict__ h,          // [N]
    const float* __restrict__ rw,         // [N] or nullptr
    float* __restrict__ partial,          // [n_chunks, F, K, 3, B1]
    int n_rows, int n_feat, int n_nodes, int n_bins1, int warps_per_block,
    int chunk_rows, int node_tile, int bin_tile, int tiles, int stage_size) {
  extern __shared__ int4 smem4[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int tile_size = node_tile * 3 * bin_tile;
  // the warps' packs [32] int4, their tiles [node_tile, 3, bin_tile], then
  // two staging buffers
  int4* pack = smem4 + warp * kWarp;
  float* tiles_base = reinterpret_cast<float*>(smem4 + warps_per_block * kWarp);
  float* acc = tiles_base + (size_t)warp * tile_size;
  uint32_t* stage = reinterpret_cast<uint32_t*>(tiles_base + (size_t)warps_per_block * tile_size);

  const int n_slots = n_feat * tiles;
  const int slot0 = blockIdx.x * warps_per_block;
  const int slot = slot0 + warp;
  const bool active = slot < n_slots;  // the last block may have idle warps
  const Tile t = warp_tile(min(slot, n_slots - 1), tiles,
                           (n_bins1 + bin_tile - 1) / bin_tile, node_tile,
                           bin_tile, n_nodes, n_bins1);
  const int f_lo = slot0 / tiles;
  const int n_staged = (min(slot0 + warps_per_block, n_slots) - 1) / tiles - f_lo + 1;

  for (int i = lane; i < tile_size; i += kWarp) acc[i] = 0.0f;

  const long long row_begin = (long long)blockIdx.y * chunk_rows;
  const long long row_end = min((long long)n_rows, row_begin + chunk_rows);
  const int n_groups = (int)((row_end - row_begin + kGroupRows - 1) / kGroupRows);
  stage_rows(stage, row_begin, row_end, bins_fm, nodes, g, h, rw, f_lo,
             n_staged, n_rows);
  cp_async_commit();
  int n_pack = 0;
  for (int grp = 0; grp < n_groups; ++grp) {
    cp_async_wait_all();  // this thread's copies of group grp landed
    // every thread's too, and every warp is done with group grp - 1, whose
    // buffer is refilled now while group grp is walked
    __syncthreads();
    const long long r0 = row_begin + (long long)grp * kGroupRows;
    if (grp + 1 < n_groups) {
      stage_rows(stage + ((grp + 1) & 1) * stage_size, r0 + kGroupRows, row_end,
                 bins_fm, nodes, g, h, rw, f_lo, n_staged, n_rows);
      cp_async_commit();
    }
    if (active)
      add_staged<kBf16>(acc, pack, n_pack, stage + (grp & 1) * stage_size,
                 (int)min((long long)kGroupRows, row_end - r0),
                 grp * kGroupBatches, t, t.f - f_lo, bin_tile, rw != nullptr, lane);
  }
  if (!active) return;  // no block-wide barrier below
  if (n_pack) add_pack(acc, pack, n_pack, bin_tile, lane);

  float* dst = partial +
               (((size_t)blockIdx.y * n_feat + t.f) * n_nodes + t.k0) * 3 * n_bins1 + t.b0;
  for (int row = 0; row < (t.k1 - t.k0) * 3; ++row)  // (node - k0) * 3 + channel
    for (int b = lane; b < t.b1 - t.b0; b += kWarp)
      dst[(size_t)row * n_bins1 + b] = acc[row * bin_tile + b];
}

// ---------------------------------------------------------------------------

__global__ void hist_reduce_kernel(
    const float* __restrict__ partial,  // [n_chunks, F, K, 3, B1]
    float* __restrict__ out,            // [K, F, B1, 3]
    int n_chunks, int n_feat, int n_nodes, int n_bins1) {
  const long long per_chunk = (long long)n_feat * n_nodes * 3 * n_bins1;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= per_chunk) return;
  double s = 0.0;
  for (int c = 0; c < n_chunks; ++c) s += (double)partial[c * per_chunk + i];
  const int b = (int)(i % n_bins1);
  long long q = i / n_bins1;
  const int ch = (int)(q % 3);
  q /= 3;
  const int k = (int)(q % n_nodes);
  const int f = (int)(q / n_nodes);
  out[(((long long)k * n_feat + f) * n_bins1 + b) * 3 + ch] = (float)s;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// Pass 1 of one call: hist_warp_kernel for one tile per feature, else
// hist_tile_kernel, in the operand mode kBf16.
template <bool kBf16>
cudaError_t launch_pass1(
    const int32_t* bins_fm, const int32_t* nodes, const float* g,
    const float* h, const float* rw, float* partial, int n_rows, int n_feat,
    int n_nodes, int n_bins1, int warps_per_block, int chunk_rows,
    int n_chunks, int node_tile, int bin_tile, cudaStream_t s) {
  const int tiles = (n_nodes + node_tile - 1) / node_tile *
                    ((n_bins1 + bin_tile - 1) / bin_tile);
  const int smem = smem_bytes(node_tile, bin_tile, tiles, warps_per_block);
  const dim3 grid((n_feat * tiles + warps_per_block - 1) / warps_per_block, n_chunks);
  cudaError_t err;
  if (tiles == 1) {
    err = allow_smem(hist_warp_kernel<kBf16>, smem);
    if (err != cudaSuccess) return err;
    hist_warp_kernel<kBf16><<<grid, warps_per_block * kWarp, smem, s>>>(
        bins_fm, nodes, g, h, rw, partial, n_rows, n_feat, n_nodes, n_bins1,
        warps_per_block, chunk_rows);
  } else {
    err = allow_smem(hist_tile_kernel<kBf16>, smem);
    if (err != cudaSuccess) return err;
    hist_tile_kernel<kBf16><<<grid, warps_per_block * kWarp, smem, s>>>(
        bins_fm, nodes, g, h, rw, partial, n_rows, n_feat, n_nodes, n_bins1,
        warps_per_block, chunk_rows, node_tile, bin_tile, tiles,
        stage_words(staged_features(warps_per_block, tiles)));
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches both passes on `stream`; returns the CUDA error code (0 = ok).
// The caller allocates `partial` ([n_chunks, F, K, 3, B1] float) and `out`
// ([K, F, B1, 3] float), has validated shapes and types, and gives the
// launch plan and the tile (ops/cuda_histogram.py launch_plan, cell_tiles).
// bf16 1 rounds the values to bf16 operands (hist_operand.cuh), 0 reads
// them as float32.
int hist_nodematmul_launch(
    const int32_t* bins_fm, const int32_t* nodes, const float* g,
    const float* h, const float* rw, float* partial, float* out,
    int n_rows, int n_feat, int n_nodes, int n_bins1, int warps_per_block,
    int chunk_rows, int n_chunks, int node_tile, int bin_tile, int bf16,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = (bf16 ? launch_pass1<true> : launch_pass1<false>)(
      bins_fm, nodes, g, h, rw, partial, n_rows, n_feat, n_nodes, n_bins1,
      warps_per_block, chunk_rows, n_chunks, node_tile, bin_tile, s);
  if (err != cudaSuccess) return (int)err;
  const long long cells = (long long)n_feat * n_nodes * 3 * n_bins1;
  const int rt = 256;
  hist_reduce_kernel<<<(unsigned)((cells + rt - 1) / rt), rt, 0, s>>>(
      partial, out, n_chunks, n_feat, n_nodes, n_bins1);
  return (int)cudaGetLastError();
}

const char* hist_nodematmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
