// Stride-1, SAME, 3x3x3 depthwise conv3d on channels-last tensors (forward).
//
//   out[b,t,h,w,c] = sum_{dt,dh,dw} x[b,t+dt-1,h+dh-1,w+dw-1,c] * w[dt,dh,dw,c]
//
// with taps outside the grid counted as zero, float32 accumulation, and the
// output in the input's type (float32 or bfloat16).
//
// Replaces the TPU kernel pmv_tpu/ops/depthwise_pallas.py::depthwise3x3x3_fwd
// (body _dw_fwd_kernel), which MViT runs for its stride-1 3x3x3 q/k/v pooling
// convs. The autograd Function runs it again for dx, on the cotangent with
// the weights flipped.
//
// Bound: bytes. Each output element costs 27 multiply-adds (54 operations)
// against 2 or 4 bytes read and written, below the card's operations per
// byte, so the least time is (bytes of x + bytes of w + bytes of out) over
// the memory rate.
//
// What held the first version back: one thread per 16-byte output vector
// loaded its 27 x and 27 w vectors through L1/L2 (54 loads per 16 bytes
// written), and other blocks fetched the same (t, h) neighbour rows again.
// A second version staged the planes t-1, t and t+1 in shared memory with
// per-thread cp.async and summed each output column by column: 9 shared
// loads (and in bfloat16 as many widenings) for every 3 multiply-adds per
// channel, 2 wasted columns per W segment, 3 planes to land before a block
// could start, and ~20 instructions of addresses and bounds per 16 bytes
// copied. Its copies and its multiply-adds took turns instead of
// overlapping.
//
// Design (staging in dw3x3x3_stage.cuh):
// - Plane by plane: a block walks its x planes in T order. Thread 0 copies
//   each plane's tile with its halo in one tensor copy (TMA), two planes
//   ahead of the one the block works on, into a ring of three slots; the
//   copy zero-fills the halo outside the grid, and no other thread spends
//   an instruction on it. A block waits for one plane at its start.
// - Each staged plane is read once: a staged x value meets all 9 taps of its
//   (dh, dw) row in the three outputs t-1, t, t+1 it feeds. A thread holds
//   the sums of those three output planes for its row and its segment of
//   kSegment columns of W, for 2 channels (3 * 7 * 2 float32 registers);
//   when plane p is done, output p-1 is complete and stored, and its
//   registers take output p+2. Per channel, 9 multiply-adds for each shared
//   load and widening, not 3, and no wasted columns.
// - Each output's sum runs in the order (dt, dh, dw), the plain version's.
// - The 27 taps of a thread's channels live in registers as float32. Left
//   to itself the compiler keeps bfloat16 taps packed and widens them again
//   at every use, an integer operation per multiply-add; an empty asm
//   statement makes the widened taps opaque, so they stay widened.
// - 2 channels a thread keep it at 128 registers, so 4 blocks of 128
//   threads fit an SM; a chunk of 2 16-byte units (32 bytes, a sector) is
//   the widest that keeps blocks at 128 threads on the 56-wide grid; its
//   column stride is a template constant, so a shared load's offset from
//   its row is an immediate.
// - Planes outside the grid are not copied or summed; indices come from
//   block and thread coordinates, not from a div/mod chain per element.
//
// Where it stands (PERF.md, section 6): 2.4x faster than the first version
// summed over one MViTv2-S forward in bfloat16 and about 3x its bytes
// bound; a launch alone costs ~5 us between two CUDA events, 17 of them a
// third of that bound.
//
// Plain C interface, loaded with ctypes: pmv_dw3x3x3_fwd returns
// cudaGetLastError() after the launch (0 when the launch was accepted).

#include "dw3x3x3_stage.cuh"

namespace {

using dw3::Geometry;
using dw3::Tile;

constexpr int kMaxThreads = 128;
// Output columns of W a thread owns: the grids of MViTv2-S are 56, 28, 14
// and 7 wide. Sums outside the grid are dropped.
constexpr int kSegment = 7;

// Channels a thread owns (its sums are stored as pairs).
template <typename T>
__host__ __device__ constexpr int channels() {
  return 2;
}

// Staged x planes: the one worked on and two in flight.
constexpr int kSlots = 3;

__host__ __device__ inline int slot_units(const Geometry& g) {
  return dw3::lines((g.th + 2) * g.pitch);
}

__host__ __device__ inline int smem_units(const Geometry& g) {
  return kSlots * slot_units(g) + dw3::kBarrierUnits;
}

// Adds staged plane p to the sums of outputs p-1 (a2, taps dt = 2), p (a1,
// dt = 1) and p+1 (a0, dt = 0) of one row and kSegment columns. `x` points
// at this thread's channels in staged row 0, column 0 of its segment; a
// staged column is kColBytes wide, so each load's offset from its row is a
// constant.
template <typename T, int N, int kColBytes>
__device__ __forceinline__ void add_plane(const char* x, int pitch_bytes,
                                          const float (&wt)[27][N],
                                          float (&a2)[kSegment][N],
                                          float (&a1)[kSegment][N],
                                          float (&a0)[kSegment][N]) {
#pragma unroll
  for (int dh = 0; dh < 3; ++dh) {
#pragma unroll
    for (int k = 0; k < kSegment + 2; ++k) {
      float xv[N];
      dw3::widen(dw3::lds_raw<T, N>(x + dh * pitch_bytes + k * kColBytes), xv);
#pragma unroll
      for (int dw = 0; dw < 3; ++dw) {
        const int j = k - dw;  // the output column this tap feeds
        if (j < 0 || j >= kSegment) continue;
        const int tap = dh * 3 + dw;
#pragma unroll
        for (int i = 0; i < N; ++i) {
          a0[j][i] = fmaf(xv[i], wt[tap][i], a0[j][i]);
          a1[j][i] = fmaf(xv[i], wt[9 + tap][i], a1[j][i]);
          a2[j][i] = fmaf(xv[i], wt[18 + tap][i], a2[j][i]);
        }
      }
    }
  }
}

// kUnitsLog2: g.nv_log2, the chunk's 16-byte units (log2), as a constant.
template <typename T, int kUnitsLog2>
__global__ void __launch_bounds__(kMaxThreads)
    dw3x3x3_fwd_kernel(const __grid_constant__ CUtensorMap xmap,
                       const T* __restrict__ w, T* __restrict__ out,
                       const Geometry g) {
  extern __shared__ __align__(128) uint4 smem[];
  constexpr int N = channels<T>();
  constexpr int kPerUnit = 16 / static_cast<int>(sizeof(T));
  const Tile tile = dw3::block_tile<T>(g);
  const int plane_units = slot_units(g);

  // Thread coordinates: N-channel group fastest, then row, then segment.
  constexpr int nq = (kPerUnit / N) << kUnitsLog2;
  const int q = threadIdx.x % nq;
  const int rest = threadIdx.x / nq;
  const int hr = rest % g.th;
  const int ws = rest / g.th * kSegment;
  const bool active = tile.h0 + hr < g.nh;
  const int c = tile.c0 + q * N;

  float wt[27][N];
#pragma unroll
  for (int k = 0; k < 27; ++k) {
    dw3::ldg<N>(w + k * g.nc + c, wt[k]);
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(wt[k][i]));
  }

  // In-grid planes first .. last, plane p into slot (p - first) % kSlots,
  // each a tensor copy issued by thread 0, plane p+2 at step p. The slot's
  // mbarrier completes once a use: phase (p - first) / kSlots.
  const int first = max(tile.t0 - 1, 0);
  const int last = min(tile.t1, g.nt - 1);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kSlots * plane_units);
  const uint32_t box_bytes = (g.th + 2) * g.pitch * 16;
  auto stage = [&](int p) {  // rows from h0-1, columns from w = -1
    if (threadIdx.x == 0 && p <= last) {
      const int s = (p - first) % kSlots;
      dw3::load_box(smem + s * plane_units, &xmap, bars + s, box_bytes,
                    tile.c0, -1, tile.h0 - 1, p, tile.b);
    }
  };
  dw3::init_barriers(bars, kSlots);
  stage(first);
  stage(first + 1);

  const int pitch_bytes = g.pitch * 16;
  const char* base = reinterpret_cast<const char*>(smem) +
                     (hr * g.pitch + (ws << kUnitsLog2)) * 16 +
                     q * N * static_cast<int>(sizeof(T));
  const int64_t row_stride = static_cast<int64_t>(g.nh) * g.nw * g.nc;
  T* dst = out + (static_cast<int64_t>(tile.b) * g.nt * g.nh + tile.h0 + hr) *
                     g.nw * g.nc +
           static_cast<int64_t>(ws) * g.nc + c;

  // Step p: add plane p (if in the grid) to the sums of outputs p-1, p and
  // p+1 held in a2, a1, a0; store output p-1; a2 then starts output p+2.
  // Returns true after the block's last plane, t1.
  auto step = [&](int p, float (&a2)[kSegment][N], float (&a1)[kSegment][N],
                  float (&a0)[kSegment][N]) {
    if (p >= first && p <= last) {
      dw3::wait_phase(bars + (p - first) % kSlots, (p - first) / kSlots & 1);
      __syncthreads();  // plane p-1's slot is free
      stage(p + 2);
      if (active) {
        add_plane<T, N, 16 << kUnitsLog2>(
            base + (p - first) % kSlots * plane_units * 16, pitch_bytes, wt,
            a2, a1, a0);
      }
    }
    if (active && p - 1 >= tile.t0) {
      T* o = dst + (p - 1) * row_stride;
#pragma unroll
      for (int j = 0; j < kSegment; ++j) {
        if (ws + j < g.nw) dw3::store2(o + j * g.nc, a2[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kSegment; ++j) {
#pragma unroll
      for (int i = 0; i < N; ++i) a2[j][i] = 0.f;
    }
    return p == tile.t1;
  };

  float a[3][kSegment][N];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int j = 0; j < kSegment; ++j) {
#pragma unroll
      for (int i = 0; i < N; ++i) a[r][j][i] = 0.f;
    }
  }
  // Three steps an iteration, the sums' roles turning, so no sum is moved.
  for (int p = tile.t0 - 1;; p += 3) {
    if (step(p, a[0], a[1], a[2])) break;
    if (step(p + 1, a[1], a[2], a[0])) break;
    if (step(p + 2, a[2], a[0], a[1])) break;
  }
}

// The chunk of a block: 1 or 2 16-byte units (g.nv_log2 = 0 or 1).
template <typename T>
cudaError_t launch(const void* x, const void* w, void* out, Geometry g,
                   int threads, int smem_bytes, cudaStream_t stream) {
  const int64_t blocks =
      static_cast<int64_t>(g.nb) * g.nchunks * g.nttiles * g.nhtiles;
  if (blocks == 0 || g.nt == 0 || g.nw == 0) return cudaSuccess;
  constexpr int kSize = static_cast<int>(sizeof(T));
  const int nq = (16 / kSize / channels<T>()) << g.nv_log2;
  const int box_w = g.pitch >> g.nv_log2;
  if (g.nv_log2 > 1 || g.sw != kSegment || threads != nq * g.th * g.nseg ||
      threads > kMaxThreads || blocks >= (int64_t{1} << 31) ||
      box_w < g.nseg * kSegment + 2 || box_w << g.nv_log2 != g.pitch ||
      smem_bytes != smem_units(g) * 16) {
    return cudaErrorInvalidValue;
  }
  CUtensorMap map;  // x, in boxes of one staged plane
  cudaError_t err = dw3::tensor_map(&map, x, g, kSize, box_w, g.th + 2);
  if (err != cudaSuccess) return err;
  const auto kernel =
      g.nv_log2 ? dw3x3x3_fwd_kernel<T, 1> : dw3x3x3_fwd_kernel<T, 0>;
  static unsigned long long allowed[2] = {0, 0};  // devices whose limit is
                                                  // raised, per kernel
  err = dw3::allow_smem(reinterpret_cast<const void*>(kernel), smem_bytes,
                        allowed[g.nv_log2]);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), threads, smem_bytes, stream>>>(
      map, static_cast<const T*>(w), static_cast<T*>(out), g);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x, out: [nb, nt, nh, nw, nc] contiguous,
// 16-byte aligned; w: [3, 3, 3, nc] contiguous, same type; nc % 8 == 0.
// th, nv_log2, nseg, sw, pitch, tt, threads and smem_bytes: the plan of
// pmv_tpu_torch/ops/depthwise.py::plan_forward.
extern "C" int pmv_dw3x3x3_fwd(const void* x, const void* w, void* out,
                               int nb, int nt, int nh, int nw, int nc, int th,
                               int nv_log2, int nseg, int sw, int pitch, int tt,
                               int threads, int smem_bytes, int dtype,
                               void* stream) {
  Geometry g{nb, nt, nh, nw, nc, th, nv_log2, nseg, sw, pitch, 0, tt, 0, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && dw3::complete(g, 4)) {
    return static_cast<int>(
        launch<float>(x, w, out, g, threads, smem_bytes, s));
  }
  if (dtype == 1 && dw3::complete(g, 2)) {
    return static_cast<int>(
        launch<__nv_bfloat16>(x, w, out, g, threads, smem_bytes, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
