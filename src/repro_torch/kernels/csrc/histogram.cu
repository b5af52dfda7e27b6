// Split-statistics histogram of the Federated Forest fit, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/histogram.py::histogram_pallas,
// which forms the histogram as a one-hot matrix product on the MXU.  This
// kernel computes what src/repro_torch/kernels/ref.py::histogram_ref does:
//
//     hist[l, f, b, c] = sum_s 1[seg_s == l] * 1[xb_{s,f} == b] * stats_{s,c}
//
// Samples whose slot lies outside [0, n_level) or whose bin is >= n_bins
// contribute nothing.  The output is (L, F, B, C) float32.
//
// What bounds it.  A launch must read N*F bin bytes, N slot ints and N*C
// stat floats and write L*F*B*C floats: 15.8 MB at the fit's largest level
// (N = 117,148, F = 96, B = 32, L = 128, C = 2), 4.7 us at 3.35 TB/s.  It
// does one add per (sample, feature, channel), about 1.4 adds per byte,
// against the ~20 float32 operations per byte an H100 can do from device
// memory.  So bytes and latency bound it, never arithmetic.
//
// Why no tensor cores.  The TPU's one-hot product does L*B times the
// arithmetic for the same bytes; float32 exactness on tensor cores would
// need three TF32 products on top; and the work is bound by bytes and
// latency.  Here every sample adds its stats into one (slot, bin) cell of a
// slab in shared memory.
//
// Design.
//   * Chunks.  The samples are cut into chunks of `chunk` samples and the
//     grid runs over (chunk, feature group, slot tile), so even the
//     node-stat launch (F = 1, one bin) fills the card.  A block's warps
//     keep one slab each: slot_tile x B x C cells.
//   * Staging.  A block copies its chunk into shared memory a sub-chunk at
//     a time with cp.async, 16 bytes a piece, into two buffers, so the next
//     sub-chunk is in flight while the block works on this one: the slots,
//     the stats and the bins of its features (xb arrives transposed,
//     (F, N), so a feature's column is contiguous).  The slots and stats
//     are read from device memory once per block for all its features.
//   * Level launch (n_bins > 1): warp w serves feature f0 + w.  The block
//     lists the sub-chunk's samples whose slot lies in its tile, in sample
//     order, and every warp walks that list 32 samples a step (two steps
//     at a time where C <= 4, the channels then held in registers).
//   * Node stats (n_bins == 1, one feature): the warps are `phases`; warp p
//     takes the 32-sample steps i of the chunk with i % phases == p, and
//     the slabs are summed in warp order at the end.
//   * Integer route.  While every stat staged so far is an integer of
//     magnitude <= int_limit (= 2^24 / chunk), the slabs hold int32 and
//     each lane adds with a shared-memory integer atomic.  Every partial
//     sum of such values is an integer of magnitude <= 2^24, exact in
//     float32 in any order, so the int slab holds the very bits the float
//     route would; at the first sub-chunk that breaks the guard the slabs
//     turn into floats in place and the float route carries on.  The route
//     never changes a result.
//   * Float route.  No atomics: within a step the lanes with one key
//     (__match_any_sync) add to their cell one after another, lowest lane
//     first.  So a warp's cell is the sum of its samples in sample order.
//   * Merge.  With one chunk the block writes the histogram.  Otherwise it
//     writes a partial slab to scratch, and the last block of its (feature
//     group, slot tile) to finish (an integer ticket per pair, after a
//     __threadfence) sums the partials in ascending chunk order, writes the
//     histogram and resets the ticket.  One launch per histogram.
//
// What fixes the bits.  A level launch gives each cell the sum, over the
// chunks in order, of the sum of the chunk's samples in sample order; the
// node stats sum each chunk's phases in warp order.  That depends on
// chunk and phases alone, which the host picks from N, B and C, never from
// F, L, the feature group, the slot tile or the list of a tile.  So folding
// every party's features into one launch gives each party the bits it
// would get alone (FF(M) == FF(1)), a frontier pass with L = cap gives the
// bits of the dense level, two launches give the same bits, and
// integer-valued stats (classification counts) sum exactly.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const uint8_t* xb_t;
  const int32_t* seg;
  const float* stats;
  float* out;
  float* part;
  unsigned* ticket;
  int n, n_feat, feat_lo, feat_hi, tile_lo, n_level, n_bins, n_chan;
  int chunk, phases, feat_per_block, slot_tile, sub;
  float int_limit;
};

// Shared-memory bytes that hold `bytes` of device memory copied from any
// address: the copy starts at the 16-byte boundary at or below it.  (The
// host's launch_plan counts the same.)
__device__ __forceinline__ int window(int bytes) {
  return ((bytes + 15) & ~15) + 16;
}

// Starts copying `bytes` of device memory at `src` into shared memory at
// `dst` in 16-byte cp.async pieces, from the 16-byte boundary at or below
// `src` to the one at or above its end: never outside the allocation that
// holds `src`.  `src` lands at dst + (src % 16).
__device__ __forceinline__ void copy_async(uint8_t* dst, const void* src,
                                           int bytes) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(src);
  const uintptr_t base = at & ~uintptr_t(15);
  const int shift = (int)(at - base);
  const int pieces = (shift + bytes + 15) >> 4;
  const unsigned to = (unsigned)__cvta_generic_to_shared(dst);
  for (int i = threadIdx.x; i < pieces; i += blockDim.x) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 ::"r"(to + 16 * i), "l"(base + 16 * i));
  }
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// kC > 0: the channel count is kC, known to the compiler, and a sample's
// stats sit in registers; kC == 0: any channel count, read as it goes.
template <int kC>
__global__ void __launch_bounds__(256) hist_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ bool last_block;
  __shared__ int warp_count[8];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const int n_chan = kC > 0 ? kC : a.n_chan;
  const int row = a.n_bins * n_chan;
  const int cells = (a.slot_tile * row + 3) & ~3;  // one warp's slab, padded
  const int all_cells = n_warps * cells;

  const int f0 = a.feat_lo + blockIdx.y * a.feat_per_block;
  const int lo = (a.tile_lo + blockIdx.z) * a.slot_tile;
  const int n_slots = min(a.slot_tile, a.n_level - lo);
  const int n_fb = min(a.feat_per_block, a.feat_hi - f0);
  const int fi = warp / a.phases;
  const int phase = warp - fi * a.phases;
  const int c0 = blockIdx.x * a.chunk;
  const int c1 = min(c0 + a.chunk, a.n);
  float* mine = smem + warp * cells;

  const int xb_window = window(a.sub);
  const int buf_bytes = window(4 * a.sub) + window(4 * a.sub * n_chan)
                        + a.feat_per_block * xb_window;
  // two staging buffers, each the sub-chunk's slots, its stats and the
  // bins of the block's features, each in a window of its own
  uint8_t* const staging = reinterpret_cast<uint8_t*>(smem + all_cells);
  const int stats_at = window(4 * a.sub);
  const int xb_at = stats_at + window(4 * a.sub * n_chan);
  // the samples of the slot tile in the current sub-chunk (a level launch)
  int32_t* const list = reinterpret_cast<int32_t*>(staging + 2 * buf_bytes);
  // starts staging the sub-chunk at s0 into buffer b; where each piece
  // lands is found again from its address when it is read
  auto stage = [&](int b, int s0) {
    const int len = min(a.sub, c1 - s0);
    uint8_t* at = staging + b * buf_bytes;
    copy_async(at, a.seg + s0, 4 * len);
    copy_async(at + stats_at, a.stats + (size_t)s0 * n_chan, 4 * len * n_chan);
    for (int g = 0; g < n_fb; ++g) {
      copy_async(at + xb_at + g * xb_window,
                 a.xb_t + (size_t)(f0 + g) * a.n + s0, len);
    }
    copy_commit();
  };

  for (int i = tid; i < all_cells / 4; i += blockDim.x) {
    reinterpret_cast<float4*>(smem)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }                                                // == int 0
  bool exact = true;                               // the integer route

  if (c0 < c1) stage(0, c0);
  for (int s0 = c0, b = 0; s0 < c1; s0 += a.sub, b ^= 1) {
    const int len = min(a.sub, c1 - s0);
    if (s0 + a.sub < c1) {
      stage(b ^ 1, s0 + a.sub);                    // the next sub-chunk
      copy_wait<1>();
    } else {
      copy_wait<0>();
    }
    __syncthreads();
    const uintptr_t mis = 15;
    const uint8_t* at = staging + b * buf_bytes;
    const int32_t* sseg = reinterpret_cast<const int32_t*>(
        at + (reinterpret_cast<uintptr_t>(a.seg + s0) & mis));
    const float* sst = reinterpret_cast<const float*>(
        at + stats_at
        + (reinterpret_cast<uintptr_t>(a.stats + (size_t)s0 * n_chan) & mis));
    if (exact) {
      bool ok = true;
      for (int i = tid; i < len * n_chan; i += blockDim.x) {
        const float v = sst[i];
        ok = ok && v == truncf(v) && fabsf(v) <= a.int_limit;
      }
      if (!__syncthreads_and(ok)) {
        // every partial so far is an exact integer: the float route would
        // hold the same values
        int32_t* as_int = reinterpret_cast<int32_t*>(smem);
        for (int i = tid; i < all_cells; i += blockDim.x) {
          smem[i] = (float)as_int[i];
        }
        exact = false;
        __syncthreads();
      }
    }
    // A level launch (one phase) walks only the samples in its slot tile:
    // the block lists them once, in sample order, for all its features.
    const bool listed = a.phases == 1;
    int m = len;
    if (listed) {
      const int per = (len + n_warps * 32 - 1) / (n_warps * 32) * 32;
      const int beg = warp * per;
      const int end = min(beg + per, len);
      int count = 0;
      for (int j0 = beg; j0 < end; j0 += 32) {
        const int j = j0 + lane;
        const bool in = j < end && (unsigned)(sseg[j] - lo) < (unsigned)n_slots;
        count += __popc(__ballot_sync(kFull, in));
      }
      if (lane == 0) warp_count[warp] = count;
      __syncthreads();
      int off = 0;
      m = 0;
      for (int w = 0; w < n_warps; ++w) {
        off += w < warp ? warp_count[w] : 0;
        m += warp_count[w];
      }
      for (int j0 = beg; j0 < end; j0 += 32) {
        const int j = j0 + lane;
        const bool in = j < end && (unsigned)(sseg[j] - lo) < (unsigned)n_slots;
        const unsigned ones = __ballot_sync(kFull, in);
        if (in) list[off + __popc(ones & ((1u << lane) - 1))] = j;
        off += __popc(ones);
      }
      __syncthreads();
    }
    if (fi < n_fb) {
      const uint8_t* col =
          at + xb_at + fi * xb_window
          + (reinterpret_cast<uintptr_t>(a.xb_t + (size_t)(f0 + fi) * a.n + s0)
             & mis);
      // kU steps of the warp at a time, their keys and loads interleaved;
      // their slab updates go in sample order
      constexpr int kU = kC > 0 ? 2 : 1;
      constexpr int kR = kC > 0 ? kC : 1;
      const int stride = 32 * a.phases;
      for (int st = phase * 32; st < m; st += kU * stride) {
        int key[kU];
        const float* v[kU];
        float x[kU][kR];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int i = st + u * stride + lane;
          key[u] = -1;
          int j = 0;
          if (i < m) {
            j = listed ? list[i] : i;
            const int slot = sseg[j] - lo;
            const int bin = col[j];
            if (slot >= 0 && slot < n_slots && bin < a.n_bins) {
              key[u] = slot * a.n_bins + bin;
            }
          }
          v[u] = sst + (key[u] >= 0 ? j : 0) * n_chan;
#pragma unroll
          for (int ch = 0; ch < kR; ++ch) {
            x[u][ch] = kC > 0 && key[u] >= 0 ? v[u][ch] : 0.0f;
          }
        }
        if (exact) {
#pragma unroll
          for (int u = 0; u < kU; ++u) {
            if (key[u] < 0) continue;
            int32_t* cell = reinterpret_cast<int32_t*>(mine) + key[u] * n_chan;
            for (int ch = 0; ch < n_chan; ++ch) {
              atomicAdd(cell + ch, (int)(kC > 0 ? x[u][ch] : v[u][ch]));
            }
          }
          continue;
        }
        // Float route: the lanes with one key add to their cell one after
        // another, lowest lane first, so every cell is the sum of its
        // samples in sample order.  The dropped lanes (key -1) set no round.
        unsigned rank[kU];
        int most = 0;
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const unsigned peers = __match_any_sync(kFull, key[u]);
          rank[u] = __popc(peers & ((1u << lane) - 1));
          most = max(most, key[u] >= 0 ? __popc(peers) : 0);
        }
        const int rounds = __reduce_max_sync(kFull, most);
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          for (int r = 0; r < rounds; ++r) {
            if (key[u] >= 0 && rank[u] == (unsigned)r) {
              float* cell = mine + key[u] * n_chan;
              for (int ch = 0; ch < n_chan; ++ch) {
                cell[ch] += kC > 0 ? x[u][ch] : v[u][ch];
              }
            }
            __syncwarp();
          }
        }
      }
    }
    __syncthreads();                               // buffer b is free again
  }
  if (exact) {
    int32_t* as_int = reinterpret_cast<int32_t*>(smem);
    for (int i = tid; i < all_cells; i += blockDim.x) {
      smem[i] = (float)as_int[i];
    }
    __syncthreads();
  }

  // This block's result, a.feat_per_block slabs at the start of its
  // shared memory: a level launch's warp slabs already lie so; the node
  // route (one feature) sums its phases' slabs in order into the first.
  const int region = a.feat_per_block * cells;
  if (a.phases > 1) {
    for (int e = tid; e < cells; e += blockDim.x) {
      float acc = smem[e];
      for (int p = 1; p < a.phases; ++p) acc += smem[p * cells + e];
      smem[e] = acc;
    }
  }
  __syncthreads();

  // With one chunk the block writes the histogram; otherwise its partial,
  // and the last block of this (feature group, slot tile) to finish sums
  // the partials in chunk order.
  const int n_chunks = gridDim.x;
  const int live = n_slots * row;
  const size_t pair = (size_t)blockIdx.y * gridDim.z + blockIdx.z;
  const int region4 = region / 4;
  auto put4 = [&](int e4, float4 v) {              // cells 4 e4 .. 4 e4 + 3
    const float sums[4] = {v.x, v.y, v.z, v.w};
    const int g = 4 * e4 / cells;
    if (g >= n_fb) return;
    for (int q = 0; q < 4; ++q) {
      const int r = 4 * e4 + q - g * cells;
      if (r >= live) return;
      const int slot = r / row;
      a.out[((size_t)(lo + slot) * a.n_feat + f0 + g) * row
            + (r - slot * row)] = sums[q];
    }
  };
  const float4* mine4 = reinterpret_cast<const float4*>(smem);
  if (n_chunks == 1) {
    for (int e4 = tid; e4 < region4; e4 += blockDim.x) put4(e4, mine4[e4]);
    return;
  }
  float4* part = reinterpret_cast<float4*>(a.part) + pair * n_chunks * region4;
  for (int e4 = tid; e4 < region4; e4 += blockDim.x) {
    __stcg(part + blockIdx.x * region4 + e4, mine4[e4]);
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    last_block = atomicAdd(a.ticket + pair, 1u) == n_chunks - 1;
  }
  __syncthreads();
  if (!last_block) return;
  constexpr int kBatch = 16;                       // chunks' loads in flight
  for (int e4 = tid; e4 < region4; e4 += blockDim.x) {
    float4 acc = __ldcg(part + e4);
    for (int k0 = 1; k0 < n_chunks; k0 += kBatch) {
      float4 x[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (k0 + u < n_chunks) x[u] = __ldcg(part + (k0 + u) * region4 + e4);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (k0 + u < n_chunks) {
          acc.x += x[u].x;
          acc.y += x[u].y;
          acc.z += x[u].z;
          acc.w += x[u].w;
        }
      }
    }
    put4(e4, acc);
  }
  if (tid == 0) a.ticket[pair] = 0u;               // ready for the next launch
}

template <int kC>
int set_smem(int bytes) {
  return (int)cudaFuncSetAttribute(
      hist_kernel<kC>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
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

// Lets every instance of the kernel use `bytes` of dynamic shared memory on
// the current device; the caller sets it once per device for the largest
// size it needs.
int ff_hist_set_smem(int bytes) {
  int e = set_smem<0>(bytes);
  if (!e) e = set_smem<1>(bytes);
  if (!e) e = set_smem<2>(bytes);
  if (!e) e = set_smem<3>(bytes);
  if (!e) e = set_smem<4>(bytes);
  return e;
}

const char* ff_hist_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Launches the histogram on `stream`; returns cudaGetLastError() after the
// launch (0 on success).  `p` holds, in order: n, n_feat, feat_lo, feat_hi,
// tile_lo, n_level, n_bins, n_chan, chunk, phases, feat_per_block,
// slot_tile, sub, n_chunks, n_groups, n_tiles, n_warps, smem.  The launch
// covers features [feat_lo, feat_hi) and slot tiles tile_lo, tile_lo + 1,
// ... over a (n_chunks, n_groups, n_tiles) grid.  The caller checks shapes,
// types and layout, plans the launch (kernels/histogram.py::launch_plan)
// and supplies the scratch: `part` (n_chunks x n_groups x n_tiles regions
// of feat_per_block slabs of slot_tile x B x C floats, each padded to 4)
// and `ticket` (n_groups x n_tiles zeros), both unused with one chunk.
int ff_histogram(const void* xb_t, const void* seg, const void* stats,
                 void* out, void* part, void* ticket, const int* p,
                 float int_limit, void* stream) {
  const Args a{(const uint8_t*)xb_t, (const int32_t*)seg,
               (const float*)stats, (float*)out, (float*)part,
               (unsigned*)ticket, p[0], p[1], p[2], p[3], p[4], p[5], p[6],
               p[7], p[8], p[9], p[10], p[11], p[12], int_limit};
  const dim3 grid(p[13], p[14], p[15]);
  const dim3 block(p[16] * 32);
  const int smem = p[17];
  cudaStream_t s = (cudaStream_t)stream;
  switch (a.n_chan) {
    case 1: hist_kernel<1><<<grid, block, smem, s>>>(a); break;
    case 2: hist_kernel<2><<<grid, block, smem, s>>>(a); break;
    case 3: hist_kernel<3><<<grid, block, smem, s>>>(a); break;
    case 4: hist_kernel<4><<<grid, block, smem, s>>>(a); break;
    default: hist_kernel<0><<<grid, block, smem, s>>>(a); break;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
