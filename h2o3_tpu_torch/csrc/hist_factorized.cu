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
// unit while K is small); the [HI, (k, c, lo)] slab is then transposed back
// to [K, F, B1, C] and cut to B1 bins. Ihi and Ilo are one-hot, so each row
// adds its (g, h, w) at exactly one cell (hi, k, c, lo) of the slab. Here
// that add is done directly, once per row:
//
//   pass 1 (fact_partial_kernel): one warp owns one (feature, row chunk)
//     unit and a private [HI, K, 3, 16] slab in shared memory, the TPU
//     kernel's layout with 3 channels (27 KB at 257 bins and K = 8). It walks
//     the chunk 32 rows at a time, one row per lane. Lanes whose rows fall in
//     the same (node, bin) cell find each other with __match_any_sync; the
//     lowest such lane adds its peers' values in lane (row) order and then
//     adds that sum into the cell. No two lanes write one cell at once, there
//     are no atomics, and the float sum order is fixed by the row order. A
//     block is a few such warps on neighbouring features of one chunk (they
//     share the chunk's node, g and h loads through L1). Each warp writes its
//     slab to the partials.
//   pass 2 (fact_reduce_kernel): one thread per output cell (k, f, b, c)
//     with b < B1 adds the chunk partials of slab cell (hi, k, c, lo) in chunk
//     order, in double, and writes [K, F, B1, 3] float. Slab cells with
//     hi * 16 + lo >= B1 (15 of them at 257 bins, where HI * 16 = 272) are
//     never written out.
//
// The partial kernel has a float32 and a bf16 instantiation (kBf16,
// hist_operand.cuh): the bf16 one rounds g, h and rw where it reads them and
// adds them in the same order, so it gives the bf16 node-matmul kernel's bits.
//
// The same call on the same inputs therefore gives bit-identical output;
// counts (sums of 1 without rw) are exact integers and a node with no rows
// is exactly zero. The row chunks are those of the node-matmul kernel
// (ops/cuda_histogram.py row_chunks), and a cell's chunk sum runs over the
// same rows in the same order, so this kernel and hist_nodematmul give the
// same bits on the same level.
//
// Bound on this card: memory, the same bytes as the node-matmul kernel. A
// call must read each row's node and, for an active row, its F bin codes and
// g, h (and rw): about N (4F + 16) bytes, ~250 MB at N = 2M, F = 28, i.e.
// ~75 us at 3.35 TB/s; the arithmetic (3 adds per active row and feature) is
// negligible. What this kernel does about it: every bin code is read once,
// coalesced, and the slabs never leave shared memory until the end. What
// still costs: the per-batch match/leader step (a few dozen instructions per
// 32 rows), and at K = 8 and 257 bins a warp's 27 KB slab lets only 8 warps
// share an SM, so memory latency is hidden only by the kUnroll batches each
// warp keeps in flight. A dense tensor-core form of the TPU contraction is
// not attempted here.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hist_operand.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kLo = 16;     // _FACT_LO: bin = hi * kLo + lo
constexpr int kUnroll = 4;  // 32-row batches whose loads are in flight together

template <bool kBf16>
__global__ void fact_partial_kernel(
    const int32_t* __restrict__ bins_fm,  // [F, N]
    const int32_t* __restrict__ nodes,    // [N]
    const float* __restrict__ g,          // [N]
    const float* __restrict__ h,          // [N]
    const float* __restrict__ rw,         // [N] or nullptr
    float* __restrict__ partial,          // [n_chunks, F, HI, K, 3, kLo]
    int n_rows, int n_feat, int n_nodes, int n_bins1, int n_hi,
    int warps_per_block, int chunk_rows) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int f = blockIdx.x * warps_per_block + warp;
  const int slab_size = n_hi * n_nodes * 3 * kLo;
  // this warp's slab [HI, K, 3, kLo] and its lane scratch [3, 32]
  float* acc = smem + (size_t)warp * (slab_size + 3 * kWarp);
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
        const int hi = code[u] / kLo;
        const int lo = code[u] % kLo;
        float* c = acc + ((size_t)hi * n_nodes + nd[u]) * 3 * kLo + lo;
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

__global__ void fact_reduce_kernel(
    const float* __restrict__ partial,  // [n_chunks, F, HI, K, 3, kLo]
    float* __restrict__ out,            // [K, F, B1, 3]
    int n_chunks, int n_feat, int n_nodes, int n_bins1, int n_hi) {
  const long long cells = (long long)n_nodes * n_feat * n_bins1 * 3;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cells) return;
  const int ch = (int)(i % 3);
  long long q = i / 3;
  const int b = (int)(q % n_bins1);
  q /= n_bins1;
  const int f = (int)(q % n_feat);
  const int k = (int)(q / n_feat);
  const int hi = b / kLo;
  const int lo = b % kLo;
  const long long per_chunk = (long long)n_feat * n_hi * n_nodes * 3 * kLo;
  const long long src =
      ((((long long)f * n_hi + hi) * n_nodes + k) * 3 + ch) * kLo + lo;
  double s = 0.0;
  for (int c = 0; c < n_chunks; ++c) s += (double)partial[c * per_chunk + src];
  out[i] = (float)s;
}

// Dynamic shared memory bytes one block of fact_partial_kernel needs
// (mirrored by _smem_bytes in h2o3_tpu_torch/ops/cuda_factorized_histogram.py).
int smem_bytes(int n_nodes, int n_hi, int warps_per_block) {
  return warps_per_block * (n_hi * n_nodes * 3 * kLo + 3 * kWarp) * 4;
}

// Pass 1 of one call in the operand mode kBf16.
template <bool kBf16>
cudaError_t launch_partial(
    const int32_t* bins_fm, const int32_t* nodes, const float* g,
    const float* h, const float* rw, float* partial, int n_rows, int n_feat,
    int n_nodes, int n_bins1, int n_hi, int warps_per_block, int chunk_rows,
    int n_chunks, cudaStream_t s) {
  const int smem = smem_bytes(n_nodes, n_hi, warps_per_block);
  cudaError_t err = cudaFuncSetAttribute(
      fact_partial_kernel<kBf16>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n_feat + warps_per_block - 1) / warps_per_block, n_chunks);
  fact_partial_kernel<kBf16><<<grid, warps_per_block * kWarp, smem, s>>>(
      bins_fm, nodes, g, h, rw, partial, n_rows, n_feat, n_nodes, n_bins1,
      n_hi, warps_per_block, chunk_rows);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches both passes on `stream`; returns the CUDA error code (0 = ok).
// The caller allocates `partial` ([n_chunks, F, HI, K, 3, 16] float, with
// HI = ceil(B1 / 16)) and `out` ([K, F, B1, 3] float) and has validated
// shapes and types. bf16 1 rounds the values to bf16 operands
// (hist_operand.cuh), 0 reads them as float32.
int hist_factorized_launch(
    const int32_t* bins_fm, const int32_t* nodes, const float* g,
    const float* h, const float* rw, float* partial, float* out,
    int n_rows, int n_feat, int n_nodes, int n_bins1, int warps_per_block,
    int chunk_rows, int n_chunks, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_hi = (n_bins1 + kLo - 1) / kLo;
  cudaError_t err = (bf16 ? launch_partial<true> : launch_partial<false>)(
      bins_fm, nodes, g, h, rw, partial, n_rows, n_feat, n_nodes, n_bins1,
      n_hi, warps_per_block, chunk_rows, n_chunks, s);
  if (err != cudaSuccess) return (int)err;
  const long long cells = (long long)n_nodes * n_feat * n_bins1 * 3;
  const int rt = 256;
  fact_reduce_kernel<<<(unsigned)((cells + rt - 1) / rt), rt, 0, s>>>(
      partial, out, n_chunks, n_feat, n_nodes, n_bins1, n_hi);
  return (int)cudaGetLastError();
}

const char* hist_factorized_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
