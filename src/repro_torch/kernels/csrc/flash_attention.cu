// Flash attention (prefill self-attention) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:76
// flash_attention (body _attn_kernel), a blocked online-softmax attention on
// the MXU.  It computes what src/repro_torch/kernels/ref.py::
// flash_attention_ref does, for q (BH, Sq, D) and k, v (BH, Sk, D), the GQA
// heads already repeated by the caller:
//
//     s[i, j] = (q_i . k_j) * scale,   visible iff j < Sk
//                                      and (not causal or j <= qpos_i)
//                                      and (no window or j > qpos_i - window)
//     out_i   = sum_j softmax_j(s[i, :]) v_j,   qpos_i = i + (Sk - Sq)
//
// The last query row is aligned with the last key row.  A row with no
// visible key gives 0, not NaN (causal rows with qpos < 0 when Sq > Sk).
// The sums run in float32 and the output has the inputs' type.  Two routes,
// chosen by the inputs' type.  kernels/attention.py sets both routes' tiles
// (TILES, F32_PAD) and passes them to nvcc as FF_* macros; its
// attention_plan gives each launch's grid and shared memory, which the
// launcher uses as they come.
//
// What bounds it on the card: operations.  At the serving path's prefill
// (causal, B = 8, H = 16, S = 2048, D = 128, bf16) the two products take
// 2 * B*H*D * S(S+1) = 137.5 GFLOP: 0.139 ms at the tensor cores' 989
// TFLOP/s in bf16, while q, k, v and the output are 268 MB, 0.080 ms at
// 3.35 TB/s.  Only the tensor cores can come near that bound: the float32
// CUDA cores peak at 67 TFLOP/s, 2.05 ms for the same products.
//
// bfloat16: tensor cores (attn_tc_kernel).  What the design does about the
// bound:
//   * both products run on the tensor cores as wgmma (m64nNk16, bf16 x bf16,
//     float32 sums): S = Q K^T reads Q and the key tile from shared memory
//     (K stored row-major is already the K-major B operand); O += P V takes
//     P from registers (the RS form) and reads the value tile row-major
//     with wgmma's B-transpose bit, so no transposed copy exists;
//   * tiles stay bf16 in shared memory, in TMA's 128-byte swizzle, which is
//     the layout the wgmma descriptors read (no bank conflicts); a row of D
//     = 128 is two 64-column boxes;
//   * one block of 288 threads per (batch*head, 128 query rows): warpgroups
//     0 and 1 consume, 64 query rows each; warp 8 is the producer, whose
//     one thread loads Q once and keeps the next key/value tiles in flight
//     with TMA through a ring of STAGES = 2 stages (mbarriers: full on
//     arrival of the bytes, empty when all eight consumer warps are done
//     with a stage).  S (64 floats), O (D/2 floats) and P (32 registers,
//     over S's) fit in the 168 registers a thread of a block this size may
//     have, with no spills, so no setmaxnreg is needed;
//   * the online softmax runs in registers on the accumulator's layout:
//     each row lives on the 4 lanes of a quad, so its max takes 2 shuffles,
//     and its sum l stays per lane until the end.  exp2 with the scale
//     times log2(e) folded into the scores.  P is rounded to bf16 only as
//     the A operand of P V -- a rounding the float32 route does not have,
//     relative error 2^-9 per weight -- and never goes to shared memory;
//     l sums the float32 P (before that rounding);
//   * 128-row key/value tiles; tiles wholly above the causal diagonal or
//     outside the window are not loaded; masks are computed only on tiles
//     that the diagonal, the window edge or the ragged end of Sk cross.
//     Masked scores are -inf and give p = exp2(-inf) = 0; a row whose max
//     is still -inf subtracts 0 instead, and l is guarded, so a row with
//     no visible key is exactly 0.  Q and K/V rows past Sq or Sk are
//     zero-filled by TMA (the maps are 3-D, so a tile never reads into the
//     next head) and never stored;
//   * the grid is one-dimensional with the query tile fastest, so the ~132
//     blocks on the card at once share a few heads' keys and values, which
//     L2 then serves (with the head fastest, each of those blocks read its
//     own head's K/V from device memory, 16 times over per head at the
//     prefill shape, and the kernel was bound by that traffic); within a
//     head the last query tile, the causal tile with the most keys, starts
//     first.
//
// float32: CUDA cores (attn_kernel, the first design, kept as it was so
// that float32 keeps full-float32 products: TF32 is off in the port and
// would break the float32 tolerance of 2e-3):
//   * one block of 256 threads per (batch*head, 64-row query tile), last
//     tile first; a loop over 64-row key/value tiles staged through shared
//     memory; q and k tiles are stored transposed (d-major, rows padded to
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
// No atomics and no split over keys on either route: each block owns its
// output rows, so two launches give the same bits.
//
// Head dims: 64, 128, and 112 (zamba2-7b's shared attention, d_model 3584
// over 32 heads).  D = 112 runs through the D = 128 body of either route;
// the tensors in device memory keep their true width DG = 112, and the
// columns 112..127 of every staged tile are zeros, which change no score
// and give output columns that are never stored:
//   * bf16: the tensor maps are encoded with the true width of 112 columns
//     (a row is 224 bytes, a multiple of TMA's 16-byte stride rule), so the
//     second 64-column box of a row reads columns 64..127 and TMA zero-fills
//     the 16 past the end, as it zero-fills rows past Sq or Sk (the
//     transaction still counts the whole box).  S = Q K^T takes 7 k16 steps
//     (112 = 7 x 16) instead of 8; O += P V runs at n = 128, so 16 of its
//     128 columns are zero work: P V is 8/7 of what it needs, the whole
//     kernel ~7 % more MMA work than D = 112 needs (the extra is written
//     down, not optimised);
//   * float32: the staged tiles are 128 columns wide, loaded for the first
//     112 and zero past them; the score loop stops at 112.

#include <cuda.h>  // CUtensorMap and cuTensorMapEncodeTiled's types
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#if !defined(FF_F32_BQ) || !defined(FF_F32_BK) || !defined(FF_F32_THREADS) || \
    !defined(FF_F32_PAD) || !defined(FF_TC_BQ) || !defined(FF_TC_BK) ||      \
    !defined(FF_TC_STAGES) || !defined(FF_TC_THREADS)
#error "the tiles come from kernels/attention.py: build through it"
#endif

namespace {

constexpr int BQ = FF_F32_BQ;            // query rows per block
constexpr int BK = FF_F32_BK;            // key rows per tile
constexpr int THREADS = FF_F32_THREADS;  // 16 row groups x 16 column groups
constexpr int PAD = FF_F32_PAD;  // row stride (floats) of the transposed tiles
static_assert(BQ == 64 && BK == 64 && THREADS == 256,
              "the float32 body: 16 x 16 threads, 4 x 4 scores each");
static_assert(PAD >= 64 && PAD % 4 == 0, "padded rows of float4s");
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void put(float* p, float x) { *p = x; }

// The width a head of DG columns is staged at: DG rounded up to 64.
template <int DG>
__host__ __device__ constexpr int padded() {
  return (DG + 63) / 64 * 64;
}

template <int D>
constexpr size_t smem_bytes() {
  // qt [D][PAD], kv [D][PAD] (k transposed, then v as [BK][D]), pt [BK][PAD]
  return (size_t)(2 * D * PAD + BK * PAD) * sizeof(float);
}

// DG: the head dim in device memory; D: the staged width (columns past DG
// are 0 in every tile).
template <typename T, int DG>
__global__ void __launch_bounds__(THREADS, 2)
attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, T* __restrict__ o, int sq, int sk,
            int causal, int has_window, int window, float scale) {
  static_assert(DG == 64 || DG == 112 || DG == 128, "D must be 64, 112 or 128");
  constexpr int D = padded<DG>();
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
  const size_t qbase = (size_t)bh * sq * DG;
  const size_t kbase = (size_t)bh * sk * DG;

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
    qt[d * PAD + r] = q0 + r < sq && d < DG
                          ? to_f32(q[qbase + (size_t)(q0 + r) * DG + d])
                          : 0.0f;
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
      kv[d * PAD + c] = k0 + c < sk && d < DG
                            ? to_f32(k[kbase + (size_t)(k0 + c) * DG + d])
                            : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < DG; ++d) {  // the columns past DG are 0
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
      const int c = i / D, d = i % D;
      kv[i] = k0 + c < sk && d < DG
                  ? to_f32(v[kbase + (size_t)(k0 + c) * DG + d])
                  : 0.0f;
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
    T* dst = o + qbase + (size_t)row * DG;
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (64 * n + c0 + j < DG)
          put(&dst[64 * n + c0 + j], acc[i][4 * n + j] / denom);
  }
}

template <typename T, int DG>
cudaError_t set_smem(int bytes) {
  return cudaFuncSetAttribute(
      attn_kernel<T, DG>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// grid (batch*head, query tiles)
template <typename T, int DG>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   dim3 grid, int smem, int sq, int sk, int causal,
                   int has_window, int window, float scale,
                   cudaStream_t stream) {
  attn_kernel<T, DG><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, causal,
      has_window, window, scale);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// bfloat16 route: TMA, mbarriers and wgmma (see the header).
namespace tc {

constexpr int BQ = FF_TC_BQ;            // query rows per block
constexpr int BK = FF_TC_BK;            // key rows per key/value tile
constexpr int STAGES = FF_TC_STAGES;    // key/value ring depth
constexpr int THREADS = FF_TC_THREADS;  // consumer warpgroups, then producer
constexpr int CONSUMERS = THREADS - 32;  // threads of the consumer warpgroups
constexpr int CONSUMER_WARPS = CONSUMERS / 32;
constexpr int ROW = 128;  // bytes of one row of a 64-column swizzled box
static_assert(BQ % 64 == 0 && CONSUMERS == 128 * (BQ / 64),
              "one consumer warpgroup per 64 query rows, one producer warp");
static_assert(BK == 128, "the scores are one m64n128k16 wgmma per k16 step");
static_assert(STAGES >= 2, "a ring: the next tiles load during the products");

// Dynamic shared memory, from a 1024-byte aligned base (TMA's 128-byte
// swizzle repeats every 8 rows of 128 bytes): Q, then the K stages, then
// the V stages, each tile as D / 64 boxes of [rows][64 columns]; then the
// mbarriers.  attention.py::attention_plan gives the launch's bytes.
template <int D>
struct Layout {
  static constexpr int kQ = BQ * D * 2;
  static constexpr int kKV = BK * D * 2;
  static constexpr int kK = kQ;
  static constexpr int kV = kQ + STAGES * kKV;
  static constexpr int kBar = kQ + 2 * STAGES * kKV;
  static constexpr int kBars = 1 + 4 * STAGES;
  static constexpr int kBytes = 1024 + kBar + 8 * kBars;
};

__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Waits for the phase of `bar` with this parity to complete.  A wait that
// lasts 10 s (a broken pipeline, never a slow one) traps instead of hanging
// the card.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  if (done) return;
  uint64_t t0, t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    if (!done && t - t0 > 10000000000ull) __trap();
  } while (!done);
}

// One box of a 3-D tensor map (columns c0.., rows c1.., head c2) into
// shared memory at `dst`, counted on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// A wgmma shared-memory descriptor of a 128-byte-swizzled operand at
// shared address `addr`: lbo and sbo in bytes, layout type 1 (128B).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void mma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void mma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void mma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Keeps the compiler from moving reads or writes of wgmma's registers
// across the asynchronous product.
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d (m64n128, f32) = [d +] a (smem desc, K-major) * b (smem desc, K-major)
__device__ __forceinline__ void mma_ss_n128(float (&d)[64], uint64_t a,
                                          uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (m64n64, f32) += a (registers, bf16 fragments) * b (smem desc, MN-major)
__device__ __forceinline__ void mma_rs_n64(float (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (m64n128, f32) += a (registers, bf16 fragments) * b (smem desc, MN-major)
__device__ __forceinline__ void mma_rs_n128(float (&d)[64],
                                          const uint32_t (&a)[4],
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int D>
struct PV;
template <>
struct PV<64> {
  __device__ __forceinline__ static void mma(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    mma_rs_n64(d, a, b);
  }
};
template <>
struct PV<128> {
  __device__ __forceinline__ static void mma(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    mma_rs_n128(d, a, b);
  }
};

// DG: the head dim in device memory (and of the tensor maps); D: the width
// the tiles are laid out and multiplied at (columns past DG are 0).
template <int DG>
__global__ void __launch_bounds__(THREADS, 1)
attn_tc_kernel(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               __nv_bfloat16* __restrict__ o, int sq, int sk, int causal,
               int has_window, int window, float scale_log2) {
  static_assert(DG == 64 || DG == 112 || DG == 128, "D must be 64, 112 or 128");
  static_assert(DG % 16 == 0, "S = Q K^T steps over the true width in k16");
  constexpr int D = padded<DG>();
  using L = Layout<D>;
  constexpr int BOXES = D / 64;  // 64-column boxes per row
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base =
      ((uint32_t)__cvta_generic_to_shared(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_q = base;
  const uint32_t bars = base + L::kBar;
  const uint32_t q_full = bars;
  // k_full(s), v_full(s), k_empty(s), v_empty(s)
  auto k_full = [&](int s) { return bars + 8 * (1 + s); };
  auto v_full = [&](int s) { return bars + 8 * (1 + STAGES + s); };
  auto k_empty = [&](int s) { return bars + 8 * (1 + 2 * STAGES + s); };
  auto v_empty = [&](int s) { return bars + 8 * (1 + 3 * STAGES + s); };
  auto s_k = [&](int s) { return base + L::kK + s * L::kKV; };
  auto s_v = [&](int s) { return base + L::kV + s * L::kKV; };

  // one block per (batch*head, query tile), the query tile fastest: the
  // blocks on the card at once share a few heads' keys and values in L2;
  // within a head the last (heaviest causal) tile runs first
  const int q_tiles = (sq + BQ - 1) / BQ;
  const int bh = blockIdx.x / q_tiles;
  const int q0 = (q_tiles - 1 - blockIdx.x % q_tiles) * BQ;
  const int offset = sk - sq;  // qpos = row + offset

  // which key tiles can hold a visible key for this query tile
  const int qpos_lo = q0 + offset;
  const int qpos_hi = min(q0 + BQ, sq) - 1 + offset;
  int k_end = sk;
  if (causal) k_end = min(k_end, qpos_hi + 1);
  int k_begin = 0;
  if (has_window) k_begin = max(k_begin, qpos_lo - window + 1);
  const int kt_lo = k_begin / BK;
  const int kt_hi = k_end > 0 ? (k_end + BK - 1) / BK : 0;
  const int n_tiles = max(kt_hi - kt_lo, 0);

  if (threadIdx.x == 0) {
    bar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      bar_init(k_full(s), 1);
      bar_init(v_full(s), 1);
      bar_init(k_empty(s), CONSUMER_WARPS);
      bar_init(v_empty(s), CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // ---- producer warp: one thread issues every load ----
    if (threadIdx.x == CONSUMERS && n_tiles > 0) {
      bar_expect_tx(q_full, L::kQ);
#pragma unroll
      for (int b = 0; b < BOXES; ++b)
        tma_load(s_q + b * BQ * ROW, &tq, q_full, 64 * b, q0, bh);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        const uint32_t ph = (i / STAGES) & 1;
        const int k0 = (kt_lo + i) * BK;
        bar_wait(k_empty(s), ph ^ 1);
        bar_expect_tx(k_full(s), L::kKV);
#pragma unroll
        for (int b = 0; b < BOXES; ++b)
          tma_load(s_k(s) + b * BK * ROW, &tk, k_full(s), 64 * b, k0, bh);
        bar_wait(v_empty(s), ph ^ 1);
        bar_expect_tx(v_full(s), L::kKV);
#pragma unroll
        for (int b = 0; b < BOXES; ++b)
          tma_load(s_v(s) + b * BK * ROW, &tv, v_full(s), 64 * b, k0, bh);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    const int cg = threadIdx.x / 128;
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    // this thread's rows of the accumulators: r and r + 8 of the
    // warpgroup's 64; its columns: 8 * i + 2 * (lane % 4) + {0, 1}
    const int row0 = q0 + 64 * cg + 16 * warp + lane / 4;
    const int wq_lo = q0 + 64 * cg + offset;               // qpos range of
    const int wq_hi = min(q0 + 64 * cg + 64, sq) - 1 + offset;  // the 64 rows
    const uint32_t s_qa = s_q + 64 * cg * ROW;

    float acc[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) acc[j] = 0.0f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};

    if (n_tiles > 0) bar_wait(q_full, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % STAGES;
      const uint32_t ph = (i / STAGES) & 1;
      const int k0 = (kt_lo + i) * BK;

      // S = Q K^T: DG / 16 steps of k16, each within one 64-column box
      // (the zero columns past DG would add nothing)
      float sc[BK / 2];
      bar_wait(k_full(s), ph);
      mma_fence();
#pragma unroll
      for (int kk = 0; kk < DG / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;  // bytes into the box
        mma_ss_n128(sc,
                    desc(s_qa + (kk / 4) * BQ * ROW + col, 16, 8 * ROW),
                    desc(s_k(s) + (kk / 4) * BK * ROW + col, 16, 8 * ROW),
                    kk > 0);
      }
      mma_commit();
      mma_wait();
      pin(sc);
      if (lane == 0) bar_arrive(k_empty(s));

      // scale (to log2 units) and mask
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) sc[j] *= scale_log2;
      const bool need_mask = k0 + BK > sk ||
                             (causal && k0 + BK - 1 > wq_lo) ||
                             (has_window && k0 <= wq_hi - window);
      if (need_mask) {
#pragma unroll
        for (int j = 0; j < BK / 2; ++j) {
          const int qpos = row0 + 8 * ((j / 2) % 2) + offset;
          const int kpos = k0 + 8 * (j / 4) + 2 * (lane % 4) + (j % 2);
          bool vis = kpos < sk;
          if (causal) vis = vis && kpos <= qpos;
          if (has_window) vis = vis && kpos > qpos - window;
          if (!vis) sc[j] = -INFINITY;
        }
      }

      // online softmax over the quad that holds each row
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < BK / 2; ++j)
        mx[(j / 2) % 2] = fmaxf(mx[(j / 2) % 2], sc[j]);
      float sub[2], alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        sub[r] = mx[r] == -INFINITY ? 0.0f : mx[r];
        alpha[r] = ex2(m[r] - sub[r]);
        m[r] = mx[r];
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) {
        sc[j] = ex2(sc[j] - sub[(j / 2) % 2]);
        l[(j / 2) % 2] += sc[j];
      }
#pragma unroll
      for (int j = 0; j < D / 2; ++j) acc[j] *= alpha[(j / 2) % 2];

      // P as the bf16 A fragments of P V: the accumulator's layout of
      // columns 16 kk .. 16 kk + 15 is the A fragment of step kk
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }

      // O += P V: the value tile row-major is B with N (= d) contiguous;
      // 8 keys of 128 bytes apart (sbo), the second 64-column box of a
      // D = 128 row one box apart (lbo)
      bar_wait(v_full(s), ph);
      mma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        PV<D>::mma(acc, pa[kk],
                   desc(s_v(s) + kk * 16 * ROW, BK * ROW, 8 * ROW));
      mma_commit();
      mma_wait();
      pin(acc);
      if (lane == 0) bar_arrive(v_empty(s));
    }

    // normalise and store this thread's two rows
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lt = l[r] + __shfl_xor_sync(0xffffffffu, l[r], 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      const float inv = 1.0f / fmaxf(lt, 1e-30f);
      const int row = row0 + 8 * r;
      if (row < sq) {
        __nv_bfloat16* dst = o + ((size_t)bh * sq + row) * DG + 2 * (lane % 4);
#pragma unroll
        for (int c = 0; c < DG / 8; ++c)  // the columns past DG are not stored
          *reinterpret_cast<__nv_bfloat162*>(dst + 8 * c) =
              __floats2bfloat162_rn(acc[4 * c + 2 * r] * inv,
                                    acc[4 * c + 2 * r + 1] * inv);
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, looked up through the runtime's
// entry-point query (so the library needs no -lcuda); null if missing.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The 3-D map (d, rows, bh) of a contiguous (bh, rows, d) bf16 tensor, in
// boxes of 64 columns x box_rows rows x 1 head, 128-byte swizzled; reads
// past `rows`, and past column d (d = 112: a box at column 64 reads 64..127),
// are zero-filled.  The row stride, 2d bytes (128, 224 or 256), is a
// multiple of 16, as TMA requires.
bool tensor_map(CUtensorMap* map, const void* ptr, int d, int rows, int bh,
                int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows,
                              (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2,
                                 (cuuint64_t)d * 2 * (cuuint64_t)rows};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The maps of the last tensors this host thread launched on.  The caching
// allocator hands each layer the buffers of the layer before, so most
// launches encode no map.
struct MapSlot {
  CUtensorMap map;
  const void* ptr;
  int d, rows, bh, box_rows;
};

bool cached_map(CUtensorMap* map, const void* ptr, int d, int rows, int bh,
                int box_rows) {
  constexpr int kSlots = 8;
  thread_local MapSlot slots[kSlots] = {};
  thread_local int next = 0;
  for (const MapSlot& s : slots)
    if (s.ptr == ptr && s.d == d && s.rows == rows && s.bh == bh &&
        s.box_rows == box_rows) {
      *map = s.map;
      return true;
    }
  MapSlot& s = slots[next];
  next = (next + 1) % kSlots;
  s.ptr = nullptr;
  if (!tensor_map(&s.map, ptr, d, rows, bh, box_rows)) return false;
  s = MapSlot{s.map, ptr, d, rows, bh, box_rows};
  *map = s.map;
  return true;
}

template <int DG>
cudaError_t set_smem(int bytes) {
  return cudaFuncSetAttribute(
      attn_tc_kernel<DG>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// grid (batch*head x query tiles), the query tile fastest; the maps have
// the tensors' true width DG
template <int DG>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   dim3 grid, int smem, int bh, int sq, int sk, int causal,
                   int has_window, int window, float scale,
                   cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  if (!cached_map(&mq, q, DG, sq, bh, BQ) ||
      !cached_map(&mk, k, DG, sk, bh, BK) ||
      !cached_map(&mv, v, DG, sk, bh, BK))
    return cudaErrorInvalidValue;
  attn_tc_kernel<DG><<<grid, THREADS, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), sq, sk, causal, has_window,
      window, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

extern "C" {

const char* ff_attn_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Lets the route of `is_bf16` at head dim `d` use `bytes` of dynamic shared
// memory per block on the current device; returns a CUDA error code.
int ff_attn_set_smem(int is_bf16, int d, int bytes) {
  switch (d) {
    case 64:
      return (int)(is_bf16 ? tc::set_smem<64>(bytes)
                           : set_smem<float, 64>(bytes));
    case 112:
      return (int)(is_bf16 ? tc::set_smem<112>(bytes)
                           : set_smem<float, 112>(bytes));
    case 128:
      return (int)(is_bf16 ? tc::set_smem<128>(bytes)
                           : set_smem<float, 128>(bytes));
  }
  return (int)cudaErrorInvalidValue;
}

// Launches the attention on `stream`; returns cudaGetLastError() after the
// launch (0 on success).  q, o: (bh, sq, d); k, v: (bh, sk, d), contiguous,
// float32 (is_bf16 = 0) or bfloat16 (is_bf16 = 1, 16-byte aligned); d is 64,
// 112 or 128.  grid_x, grid_y and smem are attention.py::attention_plan's; a
// plan with less shared memory than the route lays out is refused
// (cudaErrorInvalidValue).  The caller checks shapes, types and layout.
int ff_flash_attention(const void* q, const void* k, const void* v, void* o,
                       int bh, int sq, int sk, int d, int is_bf16, int causal,
                       int has_window, int window, float scale, int grid_x,
                       int grid_y, int smem, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bh < 1 || sq < 1 || sk < 1 || (d != 64 && d != 112 && d != 128))
    return (int)cudaErrorInvalidValue;
  // d = 112 is laid out as 128 (padded<112>())
  const size_t laid_out =
      is_bf16 ? (d == 64 ? tc::Layout<64>::kBytes : tc::Layout<128>::kBytes)
              : (d == 64 ? smem_bytes<64>() : smem_bytes<128>());
  if (smem < 0 || (size_t)smem < laid_out) return (int)cudaErrorInvalidValue;
  const dim3 grid(grid_x, grid_y);
#define FF_LAUNCH(DG)                                                       \
  return (int)(is_bf16 ? tc::launch<DG>(q, k, v, o, grid, smem, bh, sq, sk, \
                                        causal, has_window, window, scale,  \
                                        st)                                 \
                       : launch<float, DG>(q, k, v, o, grid, smem, sq, sk,  \
                                           causal, has_window, window,      \
                                           scale, st))
  switch (d) {
    case 64:
      FF_LAUNCH(64);
    case 112:
      FF_LAUNCH(112);
    default:
      FF_LAUNCH(128);
  }
#undef FF_LAUNCH
}

}  // extern "C"
