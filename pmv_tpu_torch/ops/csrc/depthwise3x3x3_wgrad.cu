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
// Design: a reduction over up to B*T*H*W = 200,704 positions per channel.
// - Registers: 27 float32 accumulators per channel, so a thread takes 2
//   channels (54 accumulators), not the forward kernel's 8.
// - A thread walks one (b, t, h) row along W and keeps the 9 neighbouring
//   rows' x at w-1, w and w+1 in registers (a 3-column window, rotated
//   without copies by unrolling the walk by 3), so each position loads 9
//   new x values and one g, not 27 and one. The halo is masked, never
//   materialised: x is read from device memory once, and the reuse across
//   the 9 rows is served by the L1 and L2 caches.
// - A block is 32 x 4 threads: threadIdx.x picks a channel pair (a warp
//   covers 64 neighbouring channels, so loads are coalesced), threadIdx.y
//   one of 4 row lanes. blockIdx.y picks a 64-channel chunk and blockIdx.x
//   a contiguous range of rows, so small grids with many channels still
//   give enough blocks.
// - Deterministic sum: each block reduces its row lanes through shared
//   memory and writes one float32 partial per (tap, channel) into scratch
//   [nblocks, 27, C]; a second kernel sums the partials in block order. No
//   atomics, so two runs give the same bits.
//
// Plain C interface, loaded with ctypes: pmv_dw3x3x3_wgrad returns
// cudaGetLastError() after the launches (0 when they were accepted).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;  // channel pairs per block
constexpr int kRows = 4;    // row lanes per block
constexpr int kTaps = 27;
constexpr int kReduceThreads = 256;

__device__ __forceinline__ void load2(const float* p, float& a, float& b) {
  const float2 v = __ldg(reinterpret_cast<const float2*>(p));
  a = v.x;
  b = v.y;
}

// A bfloat16 is the upper half of a float32, so widening is a shift.
__device__ __forceinline__ void load2(const __nv_bfloat16* p, float& a,
                                      float& b) {
  const uint32_t word = __ldg(reinterpret_cast<const unsigned int*>(p));
  a = __uint_as_float(word << 16);
  b = __uint_as_float(word & 0xffff0000u);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// x of the 9 neighbouring (dt, dh) rows at one w, for 2 channels.
struct Column {
  float v[9][2];
};

// Column at w = iw: zero outside the grid.
template <typename T>
__device__ __forceinline__ void load_column(const T* const (&rows)[9],
                                            unsigned inside, int iw, int nw,
                                            int nc, Column& col) {
  const bool in_w = iw >= 0 && iw < nw;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    if (in_w && ((inside >> k) & 1u)) {
      load2(rows[k] + static_cast<int64_t>(iw) * nc, col.v[k][0], col.v[k][1]);
    } else {
      col.v[k][0] = 0.f;
      col.v[k][1] = 0.f;
    }
  }
}

// acc[(dt, dh, dw)] += x[w + dw - 1] * g[w] for the columns at w-1, w, w+1.
__device__ __forceinline__ void accumulate(const Column& lo, const Column& mid,
                                           const Column& hi, float g0,
                                           float g1, float (&acc)[kTaps][2]) {
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    acc[k * 3][0] = fmaf(lo.v[k][0], g0, acc[k * 3][0]);
    acc[k * 3][1] = fmaf(lo.v[k][1], g1, acc[k * 3][1]);
    acc[k * 3 + 1][0] = fmaf(mid.v[k][0], g0, acc[k * 3 + 1][0]);
    acc[k * 3 + 1][1] = fmaf(mid.v[k][1], g1, acc[k * 3 + 1][1]);
    acc[k * 3 + 2][0] = fmaf(hi.v[k][0], g0, acc[k * 3 + 2][0]);
    acc[k * 3 + 2][1] = fmaf(hi.v[k][1], g1, acc[k * 3 + 2][1]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kLanes * kRows)
    dw3x3x3_wgrad_partial_kernel(const T* __restrict__ x,
                                 const T* __restrict__ g,
                                 float* __restrict__ partial, int nb, int nt,
                                 int nh, int nw, int nc, int rows_per_block) {
  const int c = (blockIdx.y * kLanes + threadIdx.x) * 2;
  const bool active = c < nc;
  const int nrows = nb * nt * nh;  // (b, t, h) rows
  const int begin = blockIdx.x * rows_per_block;
  const int end = begin + rows_per_block < nrows ? begin + rows_per_block
                                                 : nrows;

  float acc[kTaps][2];
#pragma unroll
  for (int k = 0; k < kTaps; ++k) {
    acc[k][0] = 0.f;
    acc[k][1] = 0.f;
  }

  if (active) {
    for (int r = begin + threadIdx.y; r < end; r += kRows) {
      const int ih = r % nh;
      const int it = (r / nh) % nt;
      const int ib = r / (nh * nt);
      const T* rows[9];
      unsigned inside = 0;
#pragma unroll
      for (int dt = 0; dt < 3; ++dt) {
#pragma unroll
        for (int dh = 0; dh < 3; ++dh) {
          const int tt = it + dt - 1;
          const int hh = ih + dh - 1;
          const int k = dt * 3 + dh;
          const bool in = tt >= 0 && tt < nt && hh >= 0 && hh < nh;
          inside |= static_cast<unsigned>(in) << k;
          const int64_t row =
              in ? ((static_cast<int64_t>(ib) * nt + tt) * nh + hh) * nw : 0;
          rows[k] = x + row * nc + c;
        }
      }
      const T* grow = g + static_cast<int64_t>(r) * nw * nc + c;

      Column a, b, cc;
      load_column(rows, inside, -1, nw, nc, a);
      load_column(rows, inside, 0, nw, nc, b);
      load_column(rows, inside, 1, nw, nc, cc);
      int iw = 0;
      float g0, g1;
      for (; iw + 3 <= nw; iw += 3) {
        load2(grow + static_cast<int64_t>(iw) * nc, g0, g1);
        accumulate(a, b, cc, g0, g1, acc);
        load_column(rows, inside, iw + 2, nw, nc, a);
        load2(grow + static_cast<int64_t>(iw + 1) * nc, g0, g1);
        accumulate(b, cc, a, g0, g1, acc);
        load_column(rows, inside, iw + 3, nw, nc, b);
        load2(grow + static_cast<int64_t>(iw + 2) * nc, g0, g1);
        accumulate(cc, a, b, g0, g1, acc);
        load_column(rows, inside, iw + 4, nw, nc, cc);
      }
      if (iw < nw) {
        load2(grow + static_cast<int64_t>(iw) * nc, g0, g1);
        accumulate(a, b, cc, g0, g1, acc);
        if (iw + 1 < nw) {
          load_column(rows, inside, iw + 2, nw, nc, a);
          load2(grow + static_cast<int64_t>(iw + 1) * nc, g0, g1);
          accumulate(b, cc, a, g0, g1, acc);
        }
      }
    }
  }

  // Sum the row lanes, one tap at a time, in lane order.
  __shared__ float red[kRows][kLanes * 2];
  float* out = partial + static_cast<int64_t>(blockIdx.x) * kTaps * nc;
#pragma unroll
  for (int k = 0; k < kTaps; ++k) {
    red[threadIdx.y][threadIdx.x * 2] = acc[k][0];
    red[threadIdx.y][threadIdx.x * 2 + 1] = acc[k][1];
    __syncthreads();
    if (threadIdx.y == 0 && active) {
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        s0 += red[r][threadIdx.x * 2];
        s1 += red[r][threadIdx.x * 2 + 1];
      }
      out[k * nc + c] = s0;
      out[k * nc + c + 1] = s1;
    }
    __syncthreads();
  }
}

// dw[i] = sum over blocks of partial[block, i], i = tap * C + c, in block
// order.
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
void launch(const void* x, const void* g, float* partial, void* dw, int nb,
            int nt, int nh, int nw, int nc, int nblocks, cudaStream_t stream) {
  const int nrows = nb * nt * nh;
  const int rows_per_block = nrows == 0 ? 1 : (nrows + nblocks - 1) / nblocks;
  const dim3 block(kLanes, kRows);
  const dim3 grid(static_cast<unsigned>(nblocks),
                  static_cast<unsigned>((nc / 2 + kLanes - 1) / kLanes));
  dw3x3x3_wgrad_partial_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), partial, nb, nt, nh,
      nw, nc, rows_per_block);
  const int n = kTaps * nc;
  dw3x3x3_wgrad_reduce_kernel<T>
      <<<(n + kReduceThreads - 1) / kReduceThreads, kReduceThreads, 0,
         stream>>>(partial, static_cast<T*>(dw), nblocks, n);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x, g: [nb, nt, nh, nw, nc] contiguous,
// same type, 4-byte aligned (8 for float32); nc % 8 == 0; nb * nt * nh
// below 2^31. partial: float32 scratch of nblocks * 27 * nc values. dw:
// [3, 3, 3, nc] in the inputs' type.
extern "C" int pmv_dw3x3x3_wgrad(const void* x, const void* g, void* partial,
                                 void* dw, int nb, int nt, int nh, int nw,
                                 int nc, int nblocks, int dtype,
                                 void* stream) {
  if (nc <= 0 || nc % 8 != 0 || nb < 0 || nt < 0 || nh < 0 || nw < 0 ||
      nblocks < 1 || nblocks > (1 << 30) ||
      static_cast<int64_t>(nb) * nt * nh >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  if (dtype == 0) {
    launch<float>(x, g, part, dw, nb, nt, nh, nw, nc, nblocks, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(x, g, part, dw, nb, nt, nh, nw, nc, nblocks, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
