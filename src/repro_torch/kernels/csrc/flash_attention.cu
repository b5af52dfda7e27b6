// Flash attention (prefill self-attention) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::flash_attention
// (body _attn_kernel), a blocked online-softmax attention on the MXU.  This
// kernel computes what src/repro_torch/kernels/ref.py::flash_attention_ref
// does, for q (BH, Sq, D) and k, v (BH, Sk, D), the GQA heads already
// repeated by the caller:
//
//     s[i, j] = (q_i . k_j) * scale,   visible iff j < Sk
//                                      and (not causal or j <= qpos_i)
//                                      and (no window or j > qpos_i - window)
//     out_i   = sum_j softmax_j(s[i, :]) v_j,   qpos_i = i + (Sk - Sq)
//
// The last query row is aligned with the last key row.  A row with no
// visible key gives 0, not NaN (causal rows with qpos < 0 when Sq > Sk).
// Inputs are float32 or bfloat16; the sums run in float32 and the output
// has the inputs' type.
//
// What bounds it on the card: operations.  At the serving path's prefill
// (causal, B = 8, H = 16, S = 2048, D = 128, bf16) the two products take
// 2 * B*H*D * S(S+1) = 137.5 GFLOP: 0.139 ms at the tensor cores' 989
// TFLOP/s in bf16, while q, k, v and the output are 268 MB, 0.080 ms at
// 3.35 TB/s.  This kernel runs its products as float32 FMAs on the CUDA
// cores (67 TFLOP/s), so it cannot beat about 2 ms there; one kernel then
// serves both input types at the float32 tolerance, which TF32 would break.
// wgmma, TMA and warp specialisation are later work.
//
// Design (simple and right first):
//   * one block of 256 threads per (batch*head, 64-row query tile); the
//     query tiles run last-first, so the causal tiles with the most keys
//     start first;
//   * a loop over 64-row key/value tiles staged through shared memory as
//     float32.  q and k tiles are stored transposed (d-major, rows padded to
//     68 floats), so that each thread reads 4 query rows and 4 key rows as
//     one float4 each and keeps a 4 x 4 tile of scores in registers;
//   * the 16 threads that share 4 query rows sit in one half-warp: the row
//     max and row sum of the online softmax are shuffles over 16 lanes, and
//     every thread keeps the rows' m and l in registers;
//   * p is written transposed to shared memory and the value tile is loaded
//     over the key tile's buffer; each thread accumulates 4 rows x D/16
//     columns of the output in registers;
//   * key tiles that lie wholly above the causal diagonal or wholly outside
//     the window are skipped.  That is exact: such a tile leaves m, l and the
//     accumulator unchanged (alpha = 1, p = 0).  Masked scores are -1e30
//     and their p is set to 0 after the exp, as the TPU kernel does, and l
//     is guarded with 1e-30.  Ragged Sq and Sk are masked, never read past.
// No atomics: each block owns its output rows, so two launches give the same
// bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // key rows per tile
constexpr int THREADS = 256;  // 16 row groups x 16 column groups
constexpr int PAD = 68;       // row stride (floats) of the transposed tiles
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int D>
constexpr size_t smem_bytes() {
  // qt [D][PAD], kv [D][PAD] (k transposed, then v as [BK][D]), pt [BK][PAD]
  return (size_t)(2 * D * PAD + BK * PAD) * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 2)
attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, T* __restrict__ o, int sq, int sk,
            int causal, int has_window, int window, float scale) {
  static_assert(D % 64 == 0, "D must be a multiple of 64");
  constexpr int NC = D / 64;  // float4 output columns per thread = 4 * NC
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                 // qt[d * PAD + r]
  float* kv = smem + D * PAD;       // kt[d * PAD + c], then v[c * D + d]
  float* pt = smem + 2 * D * PAD;   // pt[c * PAD + r]

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int tid = threadIdx.x;
  const int r0 = (tid >> 4) * 4;    // this thread's 4 query rows
  const int c0 = (tid & 15) * 4;    // its 4 key columns, and output columns
  const int offset = sk - sq;       // qpos = row + offset
  const size_t qbase = (size_t)bh * sq * D;
  const size_t kbase = (size_t)bh * sk * D;

  // which key tiles can hold a visible key for this query tile
  const int qpos_lo = q0 + offset;
  const int qpos_hi = min(q0 + BQ, sq) - 1 + offset;
  int k_end = sk;
  if (causal) k_end = min(k_end, qpos_hi + 1);
  int k_begin = 0;
  if (has_window) k_begin = max(k_begin, qpos_lo - window + 1);
  const int kt_lo = k_begin / BK;
  const int kt_hi = k_end > 0 ? (k_end + BK - 1) / BK : 0;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    qt[d * PAD + r] =
        q0 + r < sq ? to_f32(q[qbase + (size_t)(q0 + r) * D + d]) : 0.0f;
  }

  float m[4], l[4], acc[4][4 * NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < 4 * NC; ++j) acc[i][j] = 0.0f;
  }

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's p and v are consumed
    for (int i = tid; i < BK * D; i += THREADS) {
      const int c = i / D, d = i % D;
      kv[d * PAD + c] =
          k0 + c < sk ? to_f32(k[kbase + (size_t)(k0 + c) * D + d]) : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&qt[d * PAD + r0]);
      const float4 b = *reinterpret_cast<const float4*>(&kv[d * PAD + c0]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

    bool ok[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + r0 + i + offset;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + c0 + j;
        bool vis = kpos < sk;
        if (causal) vis = vis && kpos <= qpos;
        if (has_window) vis = vis && kpos > qpos - window;
        ok[i][j] = vis;
        s[i][j] = vis ? s[i][j] * scale : NEG;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = __expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = ok[i][j] ? __expf(s[i][j] - m_new) : 0.0f;  // p
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4 * NC; ++j) acc[i][j] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&pt[(c0 + j) * PAD + r0]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();  // every thread is done with the k tile; p is written

    for (int i = tid; i < BK * D; i += THREADS) {
      const int c = i / D;
      kv[i] = k0 + c < sk ? to_f32(v[kbase + (size_t)k0 * D + i]) : 0.0f;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(&pt[c * PAD + r0]);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const float4 b =
            *reinterpret_cast<const float4*>(&kv[c * D + 64 * n + c0]);
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][4 * n + j] = fmaf(av[i], bv[j], acc[i][4 * n + j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + r0 + i;
    if (row >= sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* dst = o + qbase + (size_t)row * D;
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        put(&dst[64 * n + c0 + j], acc[i][4 * n + j] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int bh, int sq, int sk, int causal, int has_window,
                   int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      attn_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(bh, (sq + BQ - 1) / BQ);
  attn_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, causal,
      has_window, window, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* ff_attn_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Launches the attention on `stream`; returns cudaGetLastError() after the
// launch (0 on success).  q, o: (bh, sq, d); k, v: (bh, sk, d), contiguous,
// float32 (is_bf16 = 0) or bfloat16 (is_bf16 = 1); d is 64 or 128.  The
// caller checks shapes, types and layout.
int ff_flash_attention(const void* q, const void* k, const void* v, void* o,
                       int bh, int sq, int sk, int d, int is_bf16, int causal,
                       int has_window, int window, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bh < 1 || sq < 1 || sk < 1 || (sq + BQ - 1) / BQ > 65535)
    return (int)cudaErrorInvalidValue;
  if (d == 64 && !is_bf16)
    return (int)launch<float, 64>(q, k, v, o, bh, sq, sk, causal, has_window,
                                  window, scale, st);
  if (d == 128 && !is_bf16)
    return (int)launch<float, 128>(q, k, v, o, bh, sq, sk, causal, has_window,
                                   window, scale, st);
  if (d == 64 && is_bf16)
    return (int)launch<__nv_bfloat16, 64>(q, k, v, o, bh, sq, sk, causal,
                                          has_window, window, scale, st);
  if (d == 128 && is_bf16)
    return (int)launch<__nv_bfloat16, 128>(q, k, v, o, bh, sq, sk, causal,
                                           has_window, window, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
