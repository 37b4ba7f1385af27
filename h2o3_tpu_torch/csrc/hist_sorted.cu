// Sorted per-node gradient histogram for Hopper (sm_90a).
//
// Replaces the TPU kernel `_hist_kernel` (h2o3_tpu/ops/pallas_histogram.py:353,
// prep `_prep_padded` :388, launched from the sorted branch of
// `_build_histogram_pallas_jit` :510-543). Both compute, for the nodes of
// one wide tree level (padded node count x 4 channels > 512), the histogram
//     out[k, f, b, :] = sum over rows r with node[r] == k and bin[f, r] == b
//                       of (g[r], h[r], rw[r] or 1)
// from rows sorted by node. The TPU kernel pads every node's segment to
// whole 512-row tiles and walks the tiles in order on one core, adding each
// tile's one-hot contraction into the node's resident slab. Here blocks run
// in no order, so:
//
//   prep (plain PyTorch, ops/cuda_sorted_histogram.py sorted_prep): a
//     stable sort of row ids by node (inactive rows last), each node's
//     segment offset, and a split of every segment into tiles of at most
//     `tile_rows` rows, with at least one tile per node (so an empty node
//     still owns a tile and comes out exactly zero).
//   pass 1 (sorted_partial_kernel): one block per (tile, group of up to 8
//     features), one warp per feature. The warp walks its tile 32 rows at a
//     time, one row per lane, reading each row through the sorted order
//     (the bin code of row r for feature f is bins_fm[f, r]: a gather), and
//     keeps a private [3, B1] histogram in shared memory. Lanes whose rows
//     fall in one bin find each other with __match_any_sync; the lowest such
//     lane adds its peers' values in lane (row) order and alone adds the sum
//     into the bin. No atomics, a fixed float order. Each warp writes its
//     tile's partial.
//   pass 2 (sorted_reduce_kernel): one thread per output cell adds its
//     node's tile partials in tile order, in double, and writes float.
//
// The same call on the same inputs therefore gives bit-identical output,
// and counts (sums of 1 without rw) are exact integers. Unlike the
// node-matmul kernel (hist_nodematmul.cu), a warp's histogram is one node's
// [3, B1] (3 KB at 257 bins), so its footprint does not grow with the node
// count: any K fits.
//
// Bound on this card: memory. A call must read every row's node id and, for
// an active row, its F bin codes and g, h (and rw): 4N + active (4F + 8)
// bytes, ~150 MB at N = 2M, F = 28, 63% active, i.e. ~45 us at 3.35 TB/s;
// the adds are negligible. What still costs here: the prep's sort, the
// gathers (rows of one node are spread over the whole row range, so each
// 4-byte bin code costs a 32-byte sector), g and h re-read once per feature
// group (from L1/L2), and one match/leader step per 32 rows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kUnroll = 4;  // 32-row batches whose loads are in flight together

// The node owning tile t: the largest k with tile_off[k] <= t. Every node
// owns at least one tile, so tile_off is strictly increasing.
__device__ int tile_node(const int32_t* __restrict__ tile_off, int n_nodes, int t) {
  int lo = 0, hi = n_nodes;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (tile_off[mid] <= t) lo = mid; else hi = mid;
  }
  return lo;
}

__global__ void sorted_partial_kernel(
    const int32_t* __restrict__ bins_fm,   // [F, N]
    const int32_t* __restrict__ order,     // [N] row ids sorted by node
    const int32_t* __restrict__ seg_off,   // [K + 1] segment start in order
    const int32_t* __restrict__ tile_off,  // [K + 1] first tile of each node
    const float* __restrict__ g,           // [N]
    const float* __restrict__ h,           // [N]
    const float* __restrict__ rw,          // [N] or nullptr
    float* __restrict__ partial,           // [T, F, 3, B1]
    int n_rows, int n_feat, int n_nodes, int n_bins1, int warps_per_block,
    int tile_rows) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int f = blockIdx.y * warps_per_block + warp;
  const int t = blockIdx.x;
  const int hist_size = 3 * n_bins1;
  // this warp's histogram [3, B1] and its lane scratch [3, 32]
  float* acc = smem + (size_t)warp * (hist_size + 3 * kWarp);
  float* scratch = acc + hist_size;
  // no block-wide barrier below: a warp may leave early
  if (f >= n_feat || t >= tile_off[n_nodes]) return;  // unused tiles: never read

  const int k = tile_node(tile_off, n_nodes, t);
  const long long row_begin = (long long)seg_off[k] + (long long)(t - tile_off[k]) * tile_rows;
  const long long row_end = min((long long)seg_off[k + 1], row_begin + tile_rows);
  const int32_t* codes = bins_fm + (long long)f * n_rows;

  for (int i = lane; i < hist_size; i += kWarp) acc[i] = 0.0f;
  __syncwarp();

  for (long long i0 = row_begin; i0 < row_end; i0 += kWarp * kUnroll) {
    // start every load of kUnroll batches before the first is used
    int code[kUnroll];
    float vg[kUnroll], vh[kUnroll], vw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = i0 + u * kWarp + lane;
      code[u] = -1;
      vg[u] = vh[u] = vw[u] = 0.f;
      if (i < row_end) {
        const int r = order[i];
        code[u] = codes[r];
        vg[u] = g[r];
        vh[u] = h[r];
        vw[u] = rw ? rw[r] : 1.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      // bin of this lane's row; -1 = no row. An out-of-range code counts as
      // no row: never write outside the histogram.
      const bool live = code[u] >= 0 && code[u] < n_bins1;
      const int key = live ? code[u] : -1;
      const unsigned peers = __match_any_sync(0xffffffffu, key);
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
        acc[code[u]] += sg;
        acc[n_bins1 + code[u]] += sh;
        acc[2 * n_bins1 + code[u]] += sw;
      }
      __syncwarp();  // scratch and bins settled before the next batch
    }
  }
  float* dst = partial + ((size_t)t * n_feat + f) * hist_size;
  for (int i = lane; i < hist_size; i += kWarp) dst[i] = acc[i];
}

__global__ void sorted_reduce_kernel(
    const float* __restrict__ partial,     // [T, F, 3, B1]
    const int32_t* __restrict__ tile_off,  // [K + 1]
    float* __restrict__ out,               // [K, F, B1, 3]
    int n_feat, int n_nodes, int n_bins1) {
  const long long cells = (long long)n_nodes * n_feat * n_bins1 * 3;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cells) return;
  const int ch = (int)(i % 3);
  long long q = i / 3;
  const int b = (int)(q % n_bins1);
  q /= n_bins1;
  const int f = (int)(q % n_feat);
  const int k = (int)(q / n_feat);
  double s = 0.0;
  for (int t = tile_off[k]; t < tile_off[k + 1]; ++t)
    s += (double)partial[(((long long)t * n_feat + f) * 3 + ch) * n_bins1 + b];
  out[i] = (float)s;
}

int smem_bytes(int n_bins1, int warps_per_block) {
  return warps_per_block * (3 * n_bins1 + 3 * kWarp) * 4;
}

}  // namespace

extern "C" {

// Launches both passes on `stream`; returns the CUDA error code (0 = ok).
// The caller allocates `partial` ([n_tiles, F, 3, B1] float, n_tiles an
// upper bound of tile_off[K]) and `out` ([K, F, B1, 3] float) and has
// validated shapes and types.
int hist_sorted_launch(
    const int32_t* bins_fm, const int32_t* order, const int32_t* seg_off,
    const int32_t* tile_off, const float* g, const float* h, const float* rw,
    float* partial, float* out, int n_rows, int n_feat, int n_nodes,
    int n_bins1, int warps_per_block, int tile_rows, int n_tiles, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int smem = smem_bytes(n_bins1, warps_per_block);
  cudaError_t err = cudaFuncSetAttribute(
      sorted_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_tiles, (n_feat + warps_per_block - 1) / warps_per_block);
  sorted_partial_kernel<<<grid, warps_per_block * kWarp, smem, s>>>(
      bins_fm, order, seg_off, tile_off, g, h, rw, partial, n_rows, n_feat,
      n_nodes, n_bins1, warps_per_block, tile_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long cells = (long long)n_nodes * n_feat * n_bins1 * 3;
  const int rt = 256;
  sorted_reduce_kernel<<<(unsigned)((cells + rt - 1) / rt), rt, 0, s>>>(
      partial, tile_off, out, n_feat, n_nodes, n_bins1);
  return (int)cudaGetLastError();
}

const char* hist_sorted_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
