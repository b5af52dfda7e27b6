// Split-statistics histogram of the Federated Forest fit, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/histogram.py::histogram_pallas,
// which forms the histogram as a one-hot matrix product on the MXU.  This
// kernel computes what src/repro_torch/kernels/ref.py::histogram_ref does:
//
//     hist[l, f, b, c] = sum_s 1[seg_s == l] * 1[xb_{s,f} == b] * stats_{s,c}
//
// Samples whose slot lies outside [0, n_level) or whose bin is >= n_bins
// contribute nothing.
//
// What bounds it on the card: memory.  A launch reads N*F bin bytes, N slot
// ints and N*C stat floats, writes L*F*B*C floats, and does one add per
// (sample, feature, channel) — about 1.4 adds per byte at the fit's shapes,
// far below the ~20 float32 operations per byte an H100 can do from device
// memory.  The TPU's one-hot product would do L*B times the arithmetic for
// the same bytes; here every sample adds its stats into exactly one
// (slot, bin) cell of a slab in shared memory.
//
// Design (simple and deterministic; making it fast is later work):
//   * xb arrives transposed, (F, N) uint8, so a block streams one feature's
//     column contiguously.
//   * grid = (feature, node-slot tile).  Slots are tiled so that a tile's
//     slabs fit in shared memory: one feature's (L, B, C) slab alone can
//     reach 256*256*3*4 B = 768 KiB.
//   * every warp owns a private slab of the tile.  Warp w takes the 32-sample
//     steps w, w + n_warps, w + 2*n_warps, ... in order.  Within a step the
//     lanes whose (slot, bin) keys match (__match_any_sync) sum their stats
//     in ascending lane order through shuffles, and the lowest of them adds
//     the sum to the slab.  No atomics, so the summation order is fixed.
//   * at the end the warp slabs are summed in warp order and stored.
// The order in which one cell is summed depends only on N and n_warps, and
// the host picks n_warps from B*C alone — never from F, L or the slot tile.
// So folding all parties' features into one launch gives each party the
// bits it would get alone, every launch gives the same bits, and
// integer-valued stats (classification counts) sum exactly.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void hist_kernel(const uint8_t* __restrict__ xb_t,
                            const int32_t* __restrict__ seg,
                            const float* __restrict__ stats,
                            float* __restrict__ out, int n, int n_feat,
                            int n_level, int n_bins, int n_chan,
                            int slot_tile) {
  extern __shared__ float slab[];
  const int feat = blockIdx.x;
  const int lo = blockIdx.y * slot_tile;
  const int n_slots = min(slot_tile, n_level - lo);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int cells = slot_tile * n_bins * n_chan;  // one warp's slab

  for (int i = threadIdx.x; i < n_warps * cells; i += blockDim.x) {
    slab[i] = 0.0f;
  }
  __syncthreads();

  float* mine = slab + warp * cells;
  const uint8_t* col = xb_t + (size_t)feat * n;
  for (int base = warp * 32; base < n; base += n_warps * 32) {
    const int s = base + lane;
    int key = -1;
    if (s < n) {
      const int slot = seg[s] - lo;
      const int bin = col[s];
      if (slot >= 0 && slot < n_slots && bin < n_bins) {
        key = slot * n_bins + bin;
      }
    }
    // lanes with equal keys form a group; the dropped lanes (key -1) form
    // one more group that never writes
    const unsigned peers = __match_any_sync(0xffffffffu, key);
    const int rounds = __reduce_max_sync(0xffffffffu, __popc(peers));
    const bool leader = (__ffs(peers) - 1) == lane;
    for (int ch = 0; ch < n_chan; ++ch) {
      const float v = key >= 0 ? stats[(size_t)s * n_chan + ch] : 0.0f;
      float acc = 0.0f;
      unsigned rest = peers;
      for (int r = 0; r < rounds; ++r) {
        // every lane fetches the r-th member of its own group, lowest first
        const int src = rest ? __ffs(rest) - 1 : lane;
        const float w = __shfl_sync(0xffffffffu, v, src);
        if (rest) {
          acc = r == 0 ? w : acc + w;
          rest &= rest - 1;
        }
      }
      if (key >= 0 && leader) mine[key * n_chan + ch] += acc;
    }
    __syncwarp();
  }
  __syncthreads();

  const int row = n_bins * n_chan;
  const int live = n_slots * row;
  for (int e = threadIdx.x; e < live; e += blockDim.x) {
    float acc = slab[e];
    for (int w = 1; w < n_warps; ++w) acc += slab[w * cells + e];
    const int slot = e / row;
    out[((size_t)(lo + slot) * n_feat + feat) * row + (e - slot * row)] = acc;
  }
}

}  // namespace

extern "C" {

// Shared memory a block may opt into on `device`, in bytes (negative: the
// CUDA error code).
int ff_hist_max_smem(int device) {
  int v = 0;
  const cudaError_t e = cudaDeviceGetAttribute(
      &v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return e == cudaSuccess ? v : -(int)e;
}

const char* ff_hist_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Launches the histogram on `stream`; returns cudaGetLastError() after the
// launch (0 on success).  The caller checks shapes, types and layout.
int ff_histogram(const void* xb_t, const void* seg, const void* stats,
                 void* out, int n, int n_feat, int n_level, int n_bins,
                 int n_chan, int slot_tile, int n_warps, void* stream) {
  const size_t smem =
      (size_t)n_warps * slot_tile * n_bins * n_chan * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(n_feat, (n_level + slot_tile - 1) / slot_tile);
  hist_kernel<<<grid, n_warps * 32, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)xb_t, (const int32_t*)seg, (const float*)stats,
      (float*)out, n, n_feat, n_level, n_bins, n_chan, slot_tile);
  return (int)cudaGetLastError();
}

}  // extern "C"
