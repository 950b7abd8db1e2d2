// Weight gradient of the stride-1, SAME, 3x3x3 depthwise conv3d on
// channels-last tensors:
//
//   dw[dt,dh,dw,c] = sum_{b,t,h,w} x[b,t+dt-1,h+dh-1,w+dw-1,c] * g[b,t,h,w,c]
//
// with taps outside the grid counted as zero, float32 accumulation, and dw
// written in the inputs' type (float32 or bfloat16).
//
// Replaces the dw half of the backward of the TPU kernel's custom_vjp,
// pmv_tpu/ops/depthwise_pallas.py::_bwd (27 shifted reductions); its dx half
// is the forward kernel (depthwise3x3x3.cu) run on the cotangent with the
// weights flipped.
//
// Bound: bytes. Each (position, channel) costs 27 multiply-adds against 2 or
// 4 bytes of x and of g, so the least time is (bytes of x + bytes of g) over
// the memory rate; dw is 27 * C values.
//
// What held the first version back: a thread held 27 accumulators for 2
// channels, so in bfloat16 each of its 10 global loads per position moved 4
// bytes (bound by load instructions: slower in bfloat16 than in float32), and
// the 9 neighbouring (t, h) rows came from L2 up to 9 times.
//
// Design (staging in dw3x3x3_stage.cuh):
// - A block stages its tile's x planes t-1, t, t+1 with their halo in a
//   ring of 4 shared-memory slots and the matching g plane t in a ring of 2,
//   thread 0 copying the next plane of each with one tensor copy (TMA)
//   while the block works on t; the copy zero-fills the halo.
// - The 27 taps are split across threads: a thread owns the 9 (dh, dw) taps
//   of one dt for 4 channels (36 float32 accumulators), one row of the tile
//   and a segment of W. Along W it keeps g at w-1, w, w+1 in registers and
//   reads each staged x column once: per position 3 x reads and 1 g read
//   from shared memory (8 bytes each in bfloat16, 16 in float32).
// - Deterministic sum: after the walk over T the block sums its threads'
//   accumulators through shared memory in a fixed order and writes one
//   float32 partial per (tap, channel) of its chunk into scratch
//   [B * T ranges * H tiles, 27, C]; a second kernel sums the partials in
//   that order. No atomics, so two runs give the same bits.
//
// Where it stands (PERF.md, section 6): 3.2x faster than the first version
// summed over one MViTv2-S train step, faster in bfloat16 than in float32
// at the large shapes (no longer bound by load instructions), and about 5x
// its bytes bound: its loop issues about 1.6 instructions per multiply-add
// and each call is two launches.
//
// Plain C interface, loaded with ctypes: pmv_dw3x3x3_wgrad returns
// cudaGetLastError() after the launches (0 when they were accepted).

#include "dw3x3x3_stage.cuh"

namespace {

using dw3::Geometry;
using dw3::Tile;

constexpr int kMaxThreads = 512;
constexpr int kReduceThreads = 256;

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Staged x planes: t-1, t and t+1, worked on, and t+2, in flight; staged g
// planes: t and t+1. Slots start on 128-byte lines; then one mbarrier a
// slot.
constexpr int kRing = 4;
constexpr int kGRing = 2;

__host__ __device__ inline int x_slot_units(const Geometry& g) {
  return dw3::lines((g.th + 2) * g.pitch);
}

__host__ __device__ inline int g_slot_units(const Geometry& g) {
  return dw3::lines(g.th * g.gpitch);
}

// Shared units of the staging rings and their mbarriers; the block's final
// sum reuses them.
__host__ __device__ inline int ring_units(const Geometry& g) {
  return kRing * x_slot_units(g) + kGRing * g_slot_units(g) +
         dw3::kBarrierUnits;
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    dw3x3x3_wgrad_partial_kernel(const __grid_constant__ CUtensorMap xmap,
                                 const __grid_constant__ CUtensorMap gmap,
                                 float* __restrict__ partial,
                                 const Geometry g) {
  extern __shared__ __align__(128) uint4 smem[];
  constexpr int kPerUnit = 16 / static_cast<int>(sizeof(T));
  const Tile tile = dw3::block_tile<T>(g);
  const int plane_units = x_slot_units(g);
  const int gplane_units = g_slot_units(g);
  uint4* gring = smem + kRing * plane_units;
  uint64_t* xbars = reinterpret_cast<uint64_t*>(gring + kGRing * gplane_units);
  uint64_t* gbars = xbars + kRing;

  // Thread coordinates: 4-channel group fastest, then row, then dt, then
  // segment.
  const int nq = (kPerUnit / 4) << g.nv_log2;
  const int q = threadIdx.x % nq;
  int rest = threadIdx.x / nq;
  const int hr = rest % g.th;
  rest /= g.th;
  const int dt = rest % 3;
  const int s = rest / 3;
  const int ws = s * g.sw;
  const int we = min(ws + g.sw, g.nw);
  const bool active = tile.h0 + hr < g.nh && ws < we;

  float acc[3][3][4];  // [dh][dw][channel]
#pragma unroll
  for (int dh = 0; dh < 3; ++dh) {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[dh][d][i] = 0.f;
    }
  }

  const int lane_off = q * 4 * static_cast<int>(sizeof(T));
  const int unit_log2 = g.nv_log2 + 4;  // bytes per staged column, log2
  const char* base = reinterpret_cast<const char*>(smem);

  // x planes first .. last, the in-grid ones of t0-1 .. t1 (the taps on
  // planes outside the grid are skipped), plane p into slot
  // (p - first) % kRing; g planes t0 .. t1-1, plane t into slot
  // (t - t0) % kGRing. Thread 0 issues each as one tensor copy: x planes up
  // to t0+1 and g plane t0 now, x plane t+2 and g plane t+1 at step t. A
  // slot's mbarrier completes once a use.
  const int first = max(tile.t0 - 1, 0);
  const int last = min(tile.t1, g.nt - 1);
  const uint32_t x_bytes = (g.th + 2) * g.pitch * 16;
  const uint32_t g_bytes = g.th * g.gpitch * 16;
  auto load_x = [&](int p) {  // rows from h0-1, columns from w = -1
    if (threadIdx.x == 0 && p <= last) {
      const int slot = (p - first) % kRing;
      dw3::load_box(smem + slot * plane_units, &xmap, xbars + slot, x_bytes,
                    tile.c0, -1, tile.h0 - 1, p, tile.b);
    }
  };
  auto load_g = [&](int t) {  // rows from h0, columns from w = 0
    if (threadIdx.x == 0 && t < tile.t1) {
      const int slot = (t - tile.t0) % kGRing;
      dw3::load_box(gring + slot * gplane_units, &gmap, gbars + slot, g_bytes,
                    tile.c0, 0, tile.h0, t, tile.b);
    }
  };
  dw3::init_barriers(xbars, kRing + kGRing);
  for (int p = first; p <= tile.t0 + 1; ++p) load_x(p);
  load_g(tile.t0);

  int landed = first;  // x planes before this one have landed
  for (int t = tile.t0; t < tile.t1; ++t) {
    for (; landed <= min(t + 1, last); ++landed) {
      dw3::wait_phase(xbars + (landed - first) % kRing,
                      (landed - first) / kRing & 1);
    }
    dw3::wait_phase(gbars + (t - tile.t0) % kGRing,
                    (t - tile.t0) / kGRing & 1);
    __syncthreads();  // the slots of x plane t-2 and g plane t-1 are free
    load_x(t + 2);
    load_g(t + 1);
    const int p = t + dt - 1;  // the x plane this thread's taps read
    if (!active || p < 0 || p >= g.nt) continue;

    int row[3];  // byte offset of staged x row hr+dh of plane p
#pragma unroll
    for (int dh = 0; dh < 3; ++dh) {
      row[dh] = ((p - first) % kRing * plane_units + (hr + dh) * g.pitch) *
                    16 +
                lane_off;
    }
    const int grow = (kRing * plane_units +
                      ((t - tile.t0) % kGRing) * gplane_units +
                      hr * g.gpitch) *
                         16 +
                     lane_off;

    // g at w = k-2, k-1, k (zero outside the segment); staged x column k
    // (w = k-1) meets them at dw = 2, 1, 0.
    float gm[4] = {0.f, 0.f, 0.f, 0.f};
    float g0[4] = {0.f, 0.f, 0.f, 0.f};
    float gp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
    for (int k = ws; k < we + 2; ++k) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        gm[i] = g0[i];
        g0[i] = gp[i];
        gp[i] = 0.f;
      }
      const int col = k << unit_log2;
      if (k < we) dw3::widen(dw3::lds_raw<T, 4>(base + grow + col), gp);
#pragma unroll
      for (int dh = 0; dh < 3; ++dh) {
        float xv[4];
        dw3::widen(dw3::lds_raw<T, 4>(base + row[dh] + col), xv);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[dh][0][i] = fmaf(xv[i], gp[i], acc[dh][0][i]);
          acc[dh][1][i] = fmaf(xv[i], g0[i], acc[dh][1][i]);
          acc[dh][2][i] = fmaf(xv[i], gm[i], acc[dh][2][i]);
        }
      }
    }
  }

  // The block's sum: red[lane][tap][channel], lane = s * th + hr, summed
  // over lanes in order. Every copy issued has landed.
  dw3::drop_barriers(xbars, kRing + kGRing);
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
  const int cc = nq * 4;  // channels of the chunk
  const int lane = s * g.th + hr;
#pragma unroll
  for (int dh = 0; dh < 3; ++dh) {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const int tap = dt * 9 + dh * 3 + d;
      *reinterpret_cast<float4*>(red + (lane * 27 + tap) * cc + q * 4) =
          make_float4(acc[dh][d][0], acc[dh][d][1], acc[dh][d][2],
                      acc[dh][d][3]);
    }
  }
  __syncthreads();
  const int lanes = g.th * g.nseg;
  float* out = partial + static_cast<int64_t>(tile.row) * 27 * g.nc + tile.c0;
  for (int o = threadIdx.x; o < 27 * cc; o += blockDim.x) {
    float sum = 0.f;
    for (int l = 0; l < lanes; ++l) sum += red[l * 27 * cc + o];
    out[(o / cc) * g.nc + o % cc] = sum;
  }
}

// dw[i] = sum over row blocks of partial[block, i], i = tap * C + c, in
// block order.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
    dw3x3x3_wgrad_reduce_kernel(const float* __restrict__ partial,
                                T* __restrict__ dw, int nblocks, int n) {
  const int i = blockIdx.x * kReduceThreads + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int b = 0; b < nblocks; ++b) s += partial[static_cast<int64_t>(b) * n + i];
  store1(dw + i, s);
}

template <typename T>
cudaError_t launch(const void* x, const void* g_in, float* partial, void* dw,
                   Geometry g, int threads, int smem_bytes,
                   cudaStream_t stream) {
  constexpr int kSize = static_cast<int>(sizeof(T));
  const int nq = (16 / kSize / 4) << g.nv_log2;
  const int64_t rows = static_cast<int64_t>(g.nb) * g.nttiles * g.nhtiles;
  const int64_t blocks = rows * g.nchunks;
  const int red_bytes = g.th * g.nseg * 27 * nq * 4 * 4;
  const int ring_bytes = ring_units(g) * 16;
  const int box_w = g.pitch >> g.nv_log2, gbox_w = g.gpitch >> g.nv_log2;
  if (threads != nq * g.th * 3 * g.nseg || threads > kMaxThreads ||
      box_w << g.nv_log2 != g.pitch || gbox_w << g.nv_log2 != g.gpitch ||
      gbox_w < g.nw || blocks >= (int64_t{1} << 31) ||
      smem_bytes != (ring_bytes > red_bytes ? ring_bytes : red_bytes)) {
    return cudaErrorInvalidValue;
  }
  const int n = 27 * g.nc;
  if (blocks > 0 && g.nw > 0) {
    CUtensorMap xmap, gmap;  // boxes of one staged x plane, one g plane
    cudaError_t err = dw3::tensor_map(&xmap, x, g, kSize, box_w, g.th + 2);
    if (err == cudaSuccess) {
      err = dw3::tensor_map(&gmap, g_in, g, kSize, gbox_w, g.th);
    }
    if (err != cudaSuccess) return err;
    const auto kernel = dw3x3x3_wgrad_partial_kernel<T>;
    static unsigned long long allowed = 0;  // devices whose limit is raised
    err = dw3::allow_smem(reinterpret_cast<const void*>(kernel), smem_bytes,
                          allowed);
    if (err != cudaSuccess) return err;
    kernel<<<static_cast<unsigned>(blocks), threads, smem_bytes, stream>>>(
        xmap, gmap, partial, g);
  } else if (blocks > 0) {  // W = 0: no positions, every partial is zero
    cudaError_t err = cudaMemsetAsync(
        partial, 0, static_cast<size_t>(rows) * n * sizeof(float), stream);
    if (err != cudaSuccess) return err;
  }
  // With no positions there are no partials: the sum over none is zero.
  dw3x3x3_wgrad_reduce_kernel<T>
      <<<(n + kReduceThreads - 1) / kReduceThreads, kReduceThreads, 0,
         stream>>>(partial, static_cast<T*>(dw), static_cast<int>(rows), n);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x, g: [nb, nt, nh, nw, nc] contiguous,
// same type, 16-byte aligned; nc % 8 == 0. partial: float32 scratch of
// nb * ceil(nt / tt) * ceil(nh / th) * 27 * nc values. dw: [3, 3, 3, nc] in
// the inputs' type. th, nv_log2, nseg, sw, pitch, gpitch, tt, threads and
// smem_bytes: the launch plan of pmv_tpu_torch/ops/depthwise.py::plan_wgrad.
extern "C" int pmv_dw3x3x3_wgrad(const void* x, const void* g, void* partial,
                                 void* dw, int nb, int nt, int nh, int nw,
                                 int nc, int th, int nv_log2, int nseg, int sw,
                                 int pitch, int gpitch, int tt, int threads,
                                 int smem_bytes, int dtype, void* stream) {
  Geometry geo{nb, nt,    nh,     nw, nc, th, nv_log2, nseg,
               sw, pitch, gpitch, tt, 0,  0,  0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  if (dtype == 0 && dw3::complete(geo, 4)) {
    return static_cast<int>(
        launch<float>(x, g, part, dw, geo, threads, smem_bytes, s));
  }
  if (dtype == 1 && dw3::complete(geo, 2)) {
    return static_cast<int>(
        launch<__nv_bfloat16>(x, g, part, dw, geo, threads, smem_bytes, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
