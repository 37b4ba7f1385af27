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
// That trade only pays on the TPU's matrix unit; here each row is added once:
//
//   pass 1 (hist_partial_kernel): one warp owns one (feature, row chunk)
//     unit and a private [K, 3, B1] histogram in shared memory. It walks the
//     chunk 32 rows at a time, one row per lane. Lanes whose rows fall in the
//     same (node, bin) cell find each other with __match_any_sync; the lowest
//     such lane adds its peers' values in lane order and then adds that sum
//     into the cell. So no two lanes write one cell at once, there are no
//     atomics, and the float sum order is fixed by the row order. A block is
//     a few such warps on neighbouring features of one chunk (they share the
//     chunk's node, g and h loads through L1). Each warp writes its partial.
//   pass 2 (hist_reduce_kernel): one thread per output cell adds the chunk
//     partials in chunk order, in double, and writes [K, F, B1, 3] float.
//
// The same call on the same inputs therefore gives bit-identical output.
// The row chunks depend on the row and feature counts only
// (ops/cuda_histogram.py launch_plan), so a level built for more (padded)
// nodes gives the same cells bit for bit. Counts (sum of 1 without rw) are
// exact integers.
//
// Bound on this card: memory. A call must read each row's node and, for an
// active row, its F bin codes and g, h (and rw): about N (4F + 16) bytes,
// ~250 MB at N = 2M, F = 28, i.e. ~75 us at 3.35 TB/s; the arithmetic (3
// adds per active row and feature) is negligible. What this kernel does
// about it: every bin code is read once, coalesced (feature-major rows, one
// per lane), and the histograms never leave shared memory until the end.
// What still costs: node, g and h are re-read once per feature group (from
// L2 when it holds them), bin codes of inactive rows are read too, the
// per-batch match/leader step is a few dozen instructions per 32 rows, and
// with wide levels (K x B1 large) few warps fit an SM, so memory latency
// is hidden only by the kUnroll batches each warp keeps in flight.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kUnroll = 4;  // 32-row batches whose loads are in flight together

__global__ void hist_partial_kernel(
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
        vg[u] = g[r];
        vh[u] = h[r];
        vw[u] = rw ? rw[r] : 1.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      // (node, bin) cell of this lane's row; -1 = no row. Out-of-range
      // nodes or codes count as inactive: never write outside the cells.
      const bool live = nd[u] >= 0 && nd[u] < n_nodes && code[u] >= 0 &&
                        code[u] < n_bins1;
      const int key = live ? nd[u] * n_bins1 + code[u] : -1;
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

// Dynamic shared memory bytes one block of hist_partial_kernel needs
// (mirrored by _smem_bytes in h2o3_tpu_torch/ops/cuda_histogram.py).
int smem_bytes(int n_nodes, int n_bins1, int warps_per_block) {
  return warps_per_block * (n_nodes * 3 * n_bins1 + 3 * kWarp) * 4;
}

}  // namespace

extern "C" {

// Launches both passes on `stream`; returns the CUDA error code (0 = ok).
// The caller allocates `partial` ([n_chunks, F, K, 3, B1] float) and `out`
// ([K, F, B1, 3] float) and has validated shapes and types.
int hist_nodematmul_launch(
    const int32_t* bins_fm, const int32_t* nodes, const float* g,
    const float* h, const float* rw, float* partial, float* out,
    int n_rows, int n_feat, int n_nodes, int n_bins1, int warps_per_block,
    int chunk_rows, int n_chunks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int smem = smem_bytes(n_nodes, n_bins1, warps_per_block);
  cudaError_t err = cudaFuncSetAttribute(
      hist_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_feat + warps_per_block - 1) / warps_per_block, n_chunks);
  hist_partial_kernel<<<grid, warps_per_block * kWarp, smem, s>>>(
      bins_fm, nodes, g, h, rw, partial, n_rows, n_feat, n_nodes, n_bins1,
      warps_per_block, chunk_rows);
  err = cudaGetLastError();
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
