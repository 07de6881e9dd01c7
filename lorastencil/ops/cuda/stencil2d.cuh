// 2-D stencil kernel for Hopper (sm_90a), called from JAX through the
// XLA foreign function interface (ops/hopper2d.py).
//
// One launch applies K fused timesteps.  Each block owns a TM x TN output
// tile: it stages the tile plus a K*R halo in shared memory once, runs K
// substeps on chip (each shrinks the valid extent by R and is masked to
// the bounds box, so ghost rings and sharded neighbour rings survive),
// and writes only the final tile back -- K timesteps per round trip to
// device memory.  Arithmetic is fp32 on the CUDA cores (no tensor cores,
// so no TF32 rounding); the state in device memory is fp32 or bf16.
//
// The stencil's coefficients are compiled in: ops/hopper2d.py generates a
// header per (spec, dtype, K) that defines the constants below and the tap
// function, emitting only nonzero taps.  Required definitions:
//
//   LS_R, LS_K, LS_TM, LS_TN, LS_V, LS_THREADS   (ints)
//   State               float or __nv_bfloat16
//   tap_row(a, seg, o)  o[c] += S[a][b] * seg[4 + c + b - R], c < 4
//
// A thread computes a micro-tile of V rows x 4 columns: one 16-byte
// shared-memory load feeds four outputs, and each loaded window row feeds
// up to 2R+1 output rows held in registers.  Every nonzero coefficient is
// applied from the staged tile ("dense" form): the reference's per-term
// row and column passes through a shared-memory intermediate measured
// slower on CUDA cores (PERF.md).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace ls {

constexpr int R = LS_R;
constexpr int K = LS_K;
constexpr int H = K * R;            // halo of the staged window
constexpr int TM = LS_TM;
constexpr int TN = LS_TN;
constexpr int V = LS_V;
constexpr int THREADS = LS_THREADS;
constexpr int WR = TM + 2 * H;      // window rows
constexpr int WC = TN + 2 * H;      // window cols
// smem column of window column c is c + PADL: the tile's first column
// lands on a 16-byte boundary, and 4 columns of slack sit on the left
constexpr int PADL = 4 + (4 - H % 4) % 4;
constexpr int SP = ((WC + PADL + 8 + 3) / 4) * 4;   // row pitch (floats)
constexpr int SR = WR + V;                          // rows (+ tile slack)
constexpr int BUF = SR * SP;
constexpr int NBUF = K > 1 ? 2 : 1;
constexpr int STAGE = 16;  // global loads in flight per thread

static_assert(R >= 1 && R <= 4, "a micro-tile row segment reaches 4 "
                                "columns on each side");
static_assert(TN % 4 == 0, "tiles are whole 4-column quads");

__device__ __forceinline__ float load_state(const float* p) {
  return __ldg(p);
}
__device__ __forceinline__ float load_state(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void store4(float* p, const float* v,
                                       bool aligned) {
  if (aligned) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    for (int c = 0; c < 4; ++c) p[c] = v[c];
  }
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v,
                                       bool aligned) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  if (aligned) {
    uint2 u;
    u.x = *reinterpret_cast<unsigned*>(&a);
    u.y = *reinterpret_cast<unsigned*>(&b);
    *reinterpret_cast<uint2*>(p) = u;
  } else {
    p[0] = a.x;
    p[1] = a.y;
    p[2] = b.x;
    p[3] = b.y;
  }
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// the 12 floats of a window row around a quad: smem cols cs-4 .. cs+7
__device__ __forceinline__ void load_seg(const float* row, int cs,
                                         float* seg) {
  const float4* p = reinterpret_cast<const float4*>(row + cs - 4);
  float4 a = p[0], b = p[1], c = p[2];
  seg[0] = a.x; seg[1] = a.y; seg[2] = a.z; seg[3] = a.w;
  seg[4] = b.x; seg[5] = b.y; seg[6] = b.z; seg[7] = b.w;
  seg[8] = c.x; seg[9] = c.y; seg[10] = c.z; seg[11] = c.w;
}

struct Geo {
  const State* in;
  State* out;
  int64_t cols;          // buffer row pitch (elements)
  int64_t rows;          // buffer rows
  int64_t r0, c0;        // buffer coordinates of interior cell (0, 0)
  int64_t lo0, hi0, lo1, hi1;   // written extent (interior coordinates)
};

__global__ void __launch_bounds__(THREADS)
stencil2d_kernel(Geo g, const int32_t* bounds) {
  extern __shared__ __align__(16) float smem[];
  float* bufs[NBUF];
#pragma unroll
  for (int i = 0; i < NBUF; ++i) bufs[i] = smem + i * BUF;
  const int tid = threadIdx.x;
  const int b0 = bounds[0], b1 = bounds[1], b2 = bounds[2], b3 = bounds[3];
  // interior coordinates of the tile's first output cell
  const int64_t tr = g.lo0 + int64_t(blockIdx.y) * TM;
  const int64_t tc = g.lo1 + int64_t(blockIdx.x) * TN;

  // stage the window (zero beyond the buffer's edge), STAGE loads in
  // flight per thread before any is stored
  float* X = bufs[0];
  for (int e0 = tid; e0 < WR * WC; e0 += STAGE * THREADS) {
    float v[STAGE];
#pragma unroll
    for (int j = 0; j < STAGE; ++j) {
      const int e = e0 + j * THREADS;
      const int w = e / WC, c = e % WC;
      const int64_t br = g.r0 + tr - H + w, bc = g.c0 + tc - H + c;
      v[j] = (e < WR * WC && br >= 0 && br < g.rows && bc >= 0 &&
              bc < g.cols)
                 ? load_state(g.in + br * g.cols + bc)
                 : 0.f;
    }
#pragma unroll
    for (int j = 0; j < STAGE; ++j) {
      const int e = e0 + j * THREADS;
      if (e < WR * WC) X[(e / WC) * SP + e % WC + PADL] = v[j];
    }
  }
  __syncthreads();

#pragma unroll
  for (int s = 0; s < K; ++s) {
    const int ein = H - s * R;
    const int eout = ein - R;
    const bool last = s == K - 1;
    // substeps ping-pong between bufs[0] and bufs[1]
    const float* Xs = bufs[s % 2];
    float* Y = K > 1 ? bufs[(s + 1) % 2] : nullptr;
    const int qc0 = ((H - eout + PADL) / 4) * 4;   // smem col of quad 0
    const int nq = (H + TN + eout + PADL - qc0 + 3) / 4;
    const int row0 = H - eout;
    const int nrt = (TM + 2 * eout + V - 1) / V;
    for (int it = tid; it < nrt * nq; it += THREADS) {
      const int i0 = row0 + (it / nq) * V;
      const int cs = qc0 + 4 * (it % nq);
      float acc[V][4];
#pragma unroll
      for (int v = 0; v < V; ++v)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[v][c] = 0.f;

#pragma unroll
      for (int w = 0; w < V + 2 * R; ++w) {
        float seg[12];
        load_seg(Xs + (i0 - R + w) * SP, cs, seg);
#pragma unroll
        for (int a = 0; a <= 2 * R; ++a) {
          const int v = w - a;
          if (v >= 0 && v < V) tap_row(a, seg, acc[v]);
        }
      }
      // bounds mask (interior coordinates of the micro-tile's cells)
      const int64_t gr0 = tr - H + i0;
      const int64_t gc0 = tc - H + (cs - PADL);
#pragma unroll
      for (int v = 0; v < V; ++v)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int64_t gr = gr0 + v, gc = gc0 + c;
          if (!(gr >= b0 && gr < b1 && gc >= b2 && gc < b3))
            acc[v][c] = 0.f;
        }
      if (!last) {
#pragma unroll
        for (int v = 0; v < V; ++v)
          *reinterpret_cast<float4*>(Y + (i0 + v) * SP + cs) =
              make_float4(acc[v][0], acc[v][1], acc[v][2], acc[v][3]);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const int64_t gr = gr0 + v;
          if (i0 + v >= H + TM || gr >= g.hi0) continue;
          State* p = g.out + (g.r0 + gr) * g.cols + g.c0 + gc0;
          if (gc0 + 4 <= g.hi1) {
            const bool aligned =
                ((reinterpret_cast<uintptr_t>(p)) %
                 (4 * sizeof(State))) == 0;
            store4(p, acc[v], aligned);
          } else {
            for (int c = 0; c < 4; ++c)
              if (gc0 + c < g.hi1) store1(p + c, acc[v][c]);
          }
        }
      }
    }
    if (!last) __syncthreads();
  }
}

size_t smem_bytes() { return size_t(NBUF) * BUF * sizeof(float); }

ffi::Error launch(cudaStream_t stream, ffi::AnyBuffer cur,
                  ffi::AnyBuffer donor, ffi::Buffer<ffi::S32> bounds,
                  ffi::Result<ffi::AnyBuffer> out, int64_t r0, int64_t c0,
                  int64_t lo0, int64_t hi0, int64_t lo1, int64_t hi1) {
  (void)donor;  // aliased to out: its guard ring is kept as it is
  auto dims = cur.dimensions();
  if (dims.size() != 2)
    return ffi::Error(ffi::ErrorCode::kInvalidArgument, "state is not 2-D");
  Geo g;
  g.in = reinterpret_cast<const State*>(cur.untyped_data());
  g.out = reinterpret_cast<State*>(out->untyped_data());
  g.rows = dims[0];
  g.cols = dims[1];
  g.r0 = r0;
  g.c0 = c0;
  g.lo0 = lo0;
  g.hi0 = hi0;
  g.lo1 = lo1;
  g.hi1 = hi1;
  const size_t smem = smem_bytes();
  // set on every launch: the attribute belongs to the current device,
  // and one process drives every card of a mesh (about a microsecond)
  cudaError_t attr = cudaFuncSetAttribute(
      stencil2d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (attr != cudaSuccess)
    return ffi::Error(ffi::ErrorCode::kInternal, cudaGetErrorString(attr));
  dim3 grid(unsigned((hi1 - lo1 + TN - 1) / TN),
            unsigned((hi0 - lo0 + TM - 1) / TM));
  if (grid.x == 0 || grid.y == 0) return ffi::Error::Success();
  stencil2d_kernel<<<grid, THREADS, smem, stream>>>(g, bounds.typed_data());
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess)
    return ffi::Error(ffi::ErrorCode::kInternal, cudaGetErrorString(e));
  return ffi::Error::Success();
}

}  // namespace ls

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    LsStencil2d, ls::launch,
    ffi::Ffi::Bind()
        .Ctx<ffi::PlatformStream<cudaStream_t>>()
        .Arg<ffi::AnyBuffer>()
        .Arg<ffi::AnyBuffer>()
        .Arg<ffi::Buffer<ffi::S32>>()
        .Ret<ffi::AnyBuffer>()
        .Attr<int64_t>("r0")
        .Attr<int64_t>("c0")
        .Attr<int64_t>("lo0")
        .Attr<int64_t>("hi0")
        .Attr<int64_t>("lo1")
        .Attr<int64_t>("hi1"));
