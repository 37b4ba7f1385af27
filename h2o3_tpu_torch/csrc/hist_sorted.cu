// Sorted per-node gradient histogram for Hopper (sm_90a).
//
// Replaces the TPU kernel `_hist_kernel` (h2o3_tpu/ops/pallas_histogram.py:353,
// prep `_prep_padded` :388, launched from the sorted branch of
// `_build_histogram_pallas_jit` :510-543). Both compute, for the nodes of
// one wide tree level (padded node count x 4 channels > 512), the histogram
//     out[k, f, b, :] = sum over rows r with node[r] == k and bin[f, r] == b
//                       of (g[r], h[r], rw[r] or 1)
// from rows sorted by node. The TPU kernel's prep gathers the rows into node
// order once (a row-major bins_p [T*R, F] and vals_p [T*R, C]); its kernel
// then walks whole 512-row tiles in order on one core, adding each tile's
// one-hot contraction into the node's resident slab. Here blocks run in no
// order, so:
//
//   prep (ops/cuda_sorted_histogram.py sorted_prep): a stable sort of row
//     ids by node, inactive rows last (sorted_keys_kernel writes each row's
//     key, int16 below 32,768 nodes so the sort makes half the radix passes;
//     then PyTorch's stable sort), each node's segment offset
//     (sorted_seg_kernel) and a split of every segment into tiles of at most
//     `tile_rows` rows, at least one tile per node, so an empty node still
//     owns a tile and comes out exactly zero (sorted_tiles_kernel, one
//     block's scan): three host launches.
//   gather (sorted_gather_kernel): one thread per sorted active position i,
//     r = order[i]. It reads row r's codes from `codes_rm` [N, row_elems], a
//     row-major copy of the codes in the narrowest unsigned type that holds
//     them (1 or 2 bytes here; rows padded to 16 bytes, so one 32-byte
//     sector a row at 28 features and 1 byte), with 16-byte loads, and g[r], h[r]
//     (and rw[r]); it writes them in node order: feature-major codes
//     codes_s[f, i] (a warp's 32 rows are 32 neighbouring entries of each
//     feature) and g_s[i], h_s[i] (and w_s[i]).
//   pass 1 (sorted_partial_kernel): one block per (tile, group of up to 8
//     features), one warp per feature. The warp walks its tile 32 rows at a
//     time, one row per lane, reading codes_s and g_s/h_s/w_s in order, and
//     keeps a private [3, B1] histogram in shared memory. Lanes whose rows
//     fall in one bin find each other through a per-bin lane mask in shared
//     memory (an integer atomicOr per lane: the lanes __match_any_sync
//     would give, at a fraction of its cost on this card), or, past 14,504
//     bins, where one warp's [B1] masks no longer fit beside its sums,
//     through __match_any_sync itself (kMasks = false; up to 19,338 bins);
//     the lowest such lane adds its peers' values in lane (row) order and
//     alone adds the sum into the bin. No float atomics, a fixed float
//     order. Each warp writes its tile's partial.
//   pass 2 (sorted_reduce_kernel): one thread per output cell adds its
//     node's tile partials in tile order, in double, and writes float.
//
// The gather has a float32 and a bf16 instantiation (kBf16,
// hist_operand.cuh): the bf16 one writes g_s, h_s and w_s rounded to bf16,
// where the TPU kernel's prep casts its values (`_prep_padded` :424), so pass
// 1, unchanged, sums the rounded values in its order.
//
// The bits are those of the kernel before the gather pass (which read
// bins_fm[f, order[i]], g[order[i]], ... inside pass 1): the tiles, the
// 32-row batches counted from each tile's first row, the lanes, the sums
// and the float types are unchanged, and the gather moves exactly the
// values pass 1 read before, so every cell adds the same floats in the same
// order. The same call on the same inputs gives bit-identical output, and
// counts (sums of 1 without rw) are exact integers. A code outside
// [0, n_bins1) is no row, as before: `codes_rm` holds it as a value of the
// narrow type at or above n_bins1 (ops/cuda_sorted_histogram.py
// row_major_codes, which raises where the type has no such value).
//
// Bound on this card: memory. A call must read every row's node id and, for
// an active row, its F codes and g, h (and rw): 4N + active (F W + 8) bytes
// with W-byte codes, ~58 MB at N = 2M, F = 28, 70% active and W = 1, i.e.
// ~18 us at 3.35 TB/s, plus writing the [K, F, B1, 3] output (~2 us at
// 1,024 nodes and 21 bins); the adds are negligible. (The TPU kernel's int32
// codes, W = 4, would make it ~176 MB and ~55 us.) The design moves a small multiple of
// that: the gather reads one 32-byte sector of codes and one sector of each
// value per active row (a node's rows are spread over the row range, so
// those reads are random) and writes F + 8 bytes per row in order; pass 1
// reads them back in order. Before the gather pass, pass 1 read every
// 4-byte code of a feature-major bins_fm through the sort order, one
// 32-byte sector each (~1.25 GB of sectors at 1,024 nodes). What bounds it
// now is instructions, not bytes: pass 1's mask and leader walk per 32 rows
// and feature, then the gather's random sectors and the sort.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hist_operand.cuh"

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

// prep: each row's sort key, its node, or n_nodes for a row in no node
// (-1 = inactive, or a node outside [0, n_nodes))
template <typename KeyT>
__global__ void sorted_keys_kernel(const int32_t* __restrict__ nodes,
                                   KeyT* __restrict__ keys, int n_rows,
                                   int n_nodes) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rows) return;
  const int v = nodes[i];
  keys[i] = (KeyT)((unsigned)v < (unsigned)n_nodes ? v : n_nodes);
}

// prep: seg_off[k] = the first sorted position whose key is >= k, for k in
// [0, n_nodes]; position i (and i = n_rows, past the last row) sets it for
// every k between the previous key (exclusive) and its own (inclusive)
template <typename KeyT>
__global__ void sorted_seg_kernel(const KeyT* __restrict__ keys_sorted,
                                  int32_t* __restrict__ seg_off, int n_rows,
                                  int n_nodes) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i > n_rows) return;
  const int prev = i == 0 ? -1 : keys_sorted[i - 1];
  const int cur = i == n_rows ? n_nodes : keys_sorted[i];
  for (int k = prev + 1; k <= cur; ++k) seg_off[k] = (int)i;
}

// prep, one block: tile_off[0] = 0 and tile_off[k + 1] = tile_off[k] +
// max(1, ceil(rows of node k / tile_rows)), a block-wide scan over chunks
// of blockDim.x nodes
__global__ void sorted_tiles_kernel(const int32_t* __restrict__ seg_off,
                                    int32_t* __restrict__ tile_off, int n_nodes,
                                    int tile_rows) {
  __shared__ int warp_sum[kWarp];
  __shared__ int carry;
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int n_warps = blockDim.x / kWarp;
  if (threadIdx.x == 0) {
    carry = 0;
    tile_off[0] = 0;
  }
  __syncthreads();
  for (int base = 0; base < n_nodes; base += blockDim.x) {
    const int k = base + threadIdx.x;
    int x = 0;
    if (k < n_nodes) x = max(1, (seg_off[k + 1] - seg_off[k] + tile_rows - 1) / tile_rows);
    for (int o = 1; o < kWarp; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == kWarp - 1) warp_sum[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int w = lane < n_warps ? warp_sum[lane] : 0;
      for (int o = 1; o < kWarp; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += y;
      }
      warp_sum[lane] = w;
    }
    __syncthreads();
    const int incl = carry + x + (warp > 0 ? warp_sum[warp - 1] : 0);
    if (k < n_nodes) tile_off[k + 1] = incl;
    __syncthreads();  // every thread has read carry
    if (threadIdx.x == blockDim.x - 1) carry = incl;
    __syncthreads();
  }
}

template <typename T, bool kBf16>
__global__ void sorted_gather_kernel(
    const T* __restrict__ codes_rm,        // [N, row_elems], row_elems * sizeof(T) % 16 == 0
    const int64_t* __restrict__ order,     // [N] row ids sorted by node
    const int32_t* __restrict__ seg_off,   // [K + 1]; seg_off[K] = active rows
    const float* __restrict__ g,           // [N]
    const float* __restrict__ h,           // [N]
    const float* __restrict__ rw,          // [N] or nullptr
    T* __restrict__ codes_s,               // [F, N] codes in sorted order
    float* __restrict__ g_s,               // [N]
    float* __restrict__ h_s,               // [N]
    float* __restrict__ w_s,               // [N] or nullptr (iff rw is)
    int n_rows, int n_feat, int row_elems, int n_nodes) {
  constexpr int kPer = 16 / sizeof(T);  // codes per 16-byte load
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= seg_off[n_nodes]) return;
  const long long r = order[i];
  g_s[i] = hist_operand<kBf16>(g[r]);
  h_s[i] = hist_operand<kBf16>(h[r]);
  if (rw) w_s[i] = hist_operand<kBf16>(rw[r]);
  const uint4* src = reinterpret_cast<const uint4*>(codes_rm + (size_t)r * row_elems);
  for (int c = 0; c * kPer < n_feat; ++c) {
    union { uint4 v; T e[kPer]; } u;
    u.v = src[c];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int f = c * kPer + j;
      if (f < n_feat) codes_s[(size_t)f * n_rows + i] = u.e[j];
    }
  }
}

template <typename T, bool kMasks>
__global__ void sorted_partial_kernel(
    const T* __restrict__ codes_s,         // [F, N] codes in sorted order
    const int32_t* __restrict__ seg_off,   // [K + 1] segment start in sorted order
    const int32_t* __restrict__ tile_off,  // [K + 1] first tile of each node
    const float* __restrict__ g_s,         // [N] in sorted order
    const float* __restrict__ h_s,         // [N]
    const float* __restrict__ w_s,         // [N] or nullptr
    float* __restrict__ partial,           // [T, F, 3, B1]
    int n_rows, int n_feat, int n_nodes, int n_bins1, int warps_per_block,
    int tile_rows) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int f = blockIdx.y * warps_per_block + warp;
  const int t = blockIdx.x;
  const int hist_size = 3 * n_bins1;
  // this warp's histogram [3, B1], its lane scratch [3, 32] and (kMasks)
  // its lane masks [B1]: bit l of lanes_of[b] set while lane l's row is in
  // bin b
  float* acc = smem + (size_t)warp * (hist_size + 3 * kWarp + (kMasks ? n_bins1 : 0));
  float* scratch = acc + hist_size;
  unsigned* lanes_of = reinterpret_cast<unsigned*>(scratch + 3 * kWarp);
  // no block-wide barrier below: a warp may leave early
  if (f >= n_feat || t >= tile_off[n_nodes]) return;  // unused tiles: never read

  const int k = tile_node(tile_off, n_nodes, t);
  const long long row_begin = (long long)seg_off[k] + (long long)(t - tile_off[k]) * tile_rows;
  const long long row_end = min((long long)seg_off[k + 1], row_begin + tile_rows);
  const T* codes = codes_s + (size_t)f * n_rows;

  for (int i = lane; i < hist_size; i += kWarp) acc[i] = 0.0f;
  if (kMasks)
    for (int i = lane; i < n_bins1; i += kWarp) lanes_of[i] = 0u;
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
        code[u] = (int)codes[i];
        vg[u] = g_s[i];
        vh[u] = h_s[i];
        vw[u] = w_s ? w_s[i] : 1.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      // bin of this lane's row; -1 = no row. An out-of-range code counts as
      // no row: never write outside the histogram.
      const bool live = code[u] >= 0 && code[u] < n_bins1;
      // the lanes whose rows share a bin. With kMasks each lane sets its
      // bit in its bin's mask, an integer OR, so the mask does not depend
      // on the order of the ORs; it is what __match_any_sync gives (a live
      // lane's peers), at a fraction of its cost.
      unsigned peers;
      if (kMasks) {
        if (live) atomicOr(&lanes_of[code[u]], 1u << lane);
      } else {
        peers = __match_any_sync(0xffffffffu, live ? code[u] : -1);
      }
      scratch[lane] = vg[u];
      scratch[kWarp + lane] = vh[u];
      scratch[2 * kWarp + lane] = vw[u];
      __syncwarp();
      if (kMasks) {
        peers = live ? lanes_of[code[u]] : 0u;
        __syncwarp();  // every lane has its mask before the leader clears it
      }
      if (live && lane == __ffs(peers) - 1) {
        if (kMasks) lanes_of[code[u]] = 0u;
        // peers in lane (row) order from 0; the first is this lane, whose
        // values are in its registers
        float sg = 0.f, sh = 0.f, sw = 0.f;
        sg += vg[u];
        sh += vh[u];
        sw += vw[u];
        for (unsigned m = peers & (peers - 1); m; m &= m - 1) {
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

// pass 1's dynamic shared memory (ops/cuda_sorted_histogram.py _smem_bytes)
int smem_bytes(int n_bins1, int warps_per_block, bool masks) {
  return warps_per_block * ((masks ? 4 : 3) * n_bins1 + 3 * kWarp) * 4;
}

template <typename T, bool kBf16>
int launch_gather(const void* codes_rm, int row_elems, const int64_t* order,
                  const int32_t* seg_off, const float* g, const float* h,
                  const float* rw, void* codes_s, float* g_s, float* h_s,
                  float* w_s, int n_rows, int n_feat, int n_nodes, cudaStream_t s) {
  const int gt = 256;
  sorted_gather_kernel<T, kBf16><<<(unsigned)((n_rows + gt - 1) / gt), gt, 0, s>>>(
      static_cast<const T*>(codes_rm), order, seg_off, g, h, rw,
      static_cast<T*>(codes_s), g_s, h_s, w_s, n_rows, n_feat, row_elems, n_nodes);
  return (int)cudaGetLastError();
}

template <typename T, bool kMasks>
int launch_passes(const void* codes_s, const int32_t* seg_off,
                  const int32_t* tile_off, const float* g_s, const float* h_s,
                  const float* w_s, float* partial, float* out, int n_rows,
                  int n_feat, int n_nodes, int n_bins1, int warps_per_block,
                  int tile_rows, int n_tiles, cudaStream_t s) {
  const int smem = smem_bytes(n_bins1, warps_per_block, kMasks);
  cudaError_t err = cudaFuncSetAttribute(
      sorted_partial_kernel<T, kMasks>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_tiles, (n_feat + warps_per_block - 1) / warps_per_block);
  sorted_partial_kernel<T, kMasks><<<grid, warps_per_block * kWarp, smem, s>>>(
      static_cast<const T*>(codes_s), seg_off, tile_off, g_s, h_s, w_s, partial,
      n_rows, n_feat, n_nodes, n_bins1, warps_per_block, tile_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long cells = (long long)n_nodes * n_feat * n_bins1 * 3;
  const int rt = 256;
  sorted_reduce_kernel<<<(unsigned)((cells + rt - 1) / rt), rt, 0, s>>>(
      partial, tile_off, out, n_feat, n_nodes, n_bins1);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each launcher enqueues on `stream` and returns the CUDA error code (0 =
// ok; cudaErrorInvalidValue for a code width other than 1 or 2 bytes: past
// 65,536 codes a level does not fit pass 1's shared memory, so 4-byte codes
// never reach the kernels). The caller allocates every buffer and has
// validated shapes and types.

// The prep around the sort: sort keys [N] from `nodes` [N] int32, int16
// (key_bytes 2: a sort of half the passes) or int32 (key_bytes 4).
int hist_sorted_keys(const int32_t* nodes, void* keys, int key_bytes,
                     int n_rows, int n_nodes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bt = 256;
  const unsigned grid = (unsigned)((n_rows + bt - 1) / bt);
  if (key_bytes == 2)
    sorted_keys_kernel<<<grid, bt, 0, s>>>(nodes, static_cast<int16_t*>(keys), n_rows, n_nodes);
  else if (key_bytes == 4)
    sorted_keys_kernel<<<grid, bt, 0, s>>>(nodes, static_cast<int32_t*>(keys), n_rows, n_nodes);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// The prep after the sort: `seg_off` and `tile_off` [K + 1] int32 from the
// sorted keys [N] (int16 or int32, as `hist_sorted_keys` made them).
int hist_sorted_offsets(const void* keys_sorted, int key_bytes, int32_t* seg_off,
                        int32_t* tile_off, int n_rows, int n_nodes,
                        int tile_rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bt = 256;
  const unsigned grid = (unsigned)((n_rows + bt) / bt);
  if (key_bytes == 2)
    sorted_seg_kernel<<<grid, bt, 0, s>>>(static_cast<const int16_t*>(keys_sorted),
                                          seg_off, n_rows, n_nodes);
  else if (key_bytes == 4)
    sorted_seg_kernel<<<grid, bt, 0, s>>>(static_cast<const int32_t*>(keys_sorted),
                                          seg_off, n_rows, n_nodes);
  else
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sorted_tiles_kernel<<<1, 1024, 0, s>>>(seg_off, tile_off, n_nodes, tile_rows);
  return (int)cudaGetLastError();
}

// The gather: codes_rm [N, row_elems] -> codes_s [F, N] (the code width),
// g, h (, rw) [N] -> g_s, h_s (, w_s) [N] float, at the sorted active
// positions 0 .. seg_off[K]-1 (the rest is not written); bf16 1 writes the
// values rounded to bf16 (hist_operand.cuh), 0 as they are.
int hist_sorted_gather(
    const void* codes_rm, int code_bytes, int row_elems, const int64_t* order,
    const int32_t* seg_off, const float* g, const float* h, const float* rw,
    void* codes_s, float* g_s, float* h_s, float* w_s, int n_rows, int n_feat,
    int n_nodes, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define H2O3_GATHER(T, B)                                                          \
  launch_gather<T, B>(codes_rm, row_elems, order, seg_off, g, h, rw, codes_s, g_s, \
                      h_s, w_s, n_rows, n_feat, n_nodes, s)
  switch (code_bytes * 2 + (bf16 ? 1 : 0)) {
    case 2: return H2O3_GATHER(uint8_t, false);
    case 3: return H2O3_GATHER(uint8_t, true);
    case 4: return H2O3_GATHER(uint16_t, false);
    case 5: return H2O3_GATHER(uint16_t, true);
    default: return (int)cudaErrorInvalidValue;
  }
#undef H2O3_GATHER
}

// Pass 1 and pass 2 on the gathered rows: `partial` is [n_tiles, F, 3, B1]
// float (n_tiles an upper bound of tile_off[K]), `out` [K, F, B1, 3] float;
// lane_masks 1 finds a batch's peers from lane masks in shared memory, 0
// with __match_any_sync (the same peers).
int hist_sorted_launch(
    const void* codes_s, int code_bytes, const int32_t* seg_off,
    const int32_t* tile_off, const float* g_s, const float* h_s,
    const float* w_s, float* partial, float* out, int n_rows, int n_feat,
    int n_nodes, int n_bins1, int warps_per_block, int tile_rows, int n_tiles,
    int lane_masks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define H2O3_PASSES(T, M)                                                        \
  launch_passes<T, M>(codes_s, seg_off, tile_off, g_s, h_s, w_s, partial, out, \
                      n_rows, n_feat, n_nodes, n_bins1, warps_per_block,       \
                      tile_rows, n_tiles, s)
  switch (code_bytes * 2 + (lane_masks ? 1 : 0)) {
    case 3: return H2O3_PASSES(uint8_t, true);
    case 2: return H2O3_PASSES(uint8_t, false);
    case 5: return H2O3_PASSES(uint16_t, true);
    case 4: return H2O3_PASSES(uint16_t, false);
    default: return (int)cudaErrorInvalidValue;
  }
#undef H2O3_PASSES
}

const char* hist_sorted_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
