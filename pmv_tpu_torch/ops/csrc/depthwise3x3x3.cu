// Stride-1, SAME, 3x3x3 depthwise conv3d on channels-last tensors (forward).
//
//   out[b,t,h,w,c] = sum_{dt,dh,dw} x[b,t+dt-1,h+dh-1,w+dw-1,c] * w[dt,dh,dw,c]
//
// with taps outside the grid counted as zero, float32 accumulation, and the
// output in the input's type (float32 or bfloat16).
//
// Replaces the TPU kernel pmv_tpu/ops/depthwise_pallas.py::depthwise3x3x3_fwd
// (body _dw_fwd_kernel), which MViT runs for its stride-1 3x3x3 q/k/v pooling
// convs.
//
// Bound: bytes. Each output element costs 27 multiply-adds (54 operations)
// against 2 or 4 bytes read and written, far below the card's operations per
// byte, so the least time is (bytes of x + bytes of w + bytes of out) over
// the memory rate.
//
// Design: one thread per (b, t, h, w) and 16-byte channel vector (8 bf16 or
// 4 float32 channels); neighbouring threads take neighbouring vectors, so
// every load and store is a coalesced 16-byte access. The halo is masked at
// the grid's edges instead of being materialised: unlike the TPU version,
// which pads x in device memory before the kernel, this kernel never writes
// a padded copy, so x is read from device memory once and its 27-fold reuse
// is served by the L1 and L2 caches. Any H, W (portrait grids included) and
// any C that is a multiple of 8 are taken.
//
// Plain C interface, loaded with ctypes: pmv_dw3x3x3_fwd returns
// cudaGetLastError() after the launch (0 when the launch was accepted).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
struct Lanes;
template <>
struct Lanes<float> {
  static constexpr int n = 4;
};
template <>
struct Lanes<__nv_bfloat16> {
  static constexpr int n = 8;
};

__device__ __forceinline__ void load16(const float* p, float* v) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
}

// A bfloat16 is the upper half of a float32, so widening is a shift.
__device__ __forceinline__ void widen2(uint32_t word, float* v) {
  v[0] = __uint_as_float(word << 16);
  v[1] = __uint_as_float(word & 0xffff0000u);
}

__device__ __forceinline__ uint32_t narrow2(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi)))
          << 16);
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* v) {
  const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
  widen2(a.x, v);
  widen2(a.y, v + 2);
  widen2(a.z, v + 4);
  widen2(a.w, v + 6);
}

__device__ __forceinline__ void store16(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store16(__nv_bfloat16* p, const float* v) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(narrow2(v[0], v[1]), narrow2(v[2], v[3]),
                 narrow2(v[4], v[5]), narrow2(v[6], v[7]));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dw3x3x3_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       T* __restrict__ out, int nb, int nt, int nh, int nw,
                       int nc) {
  constexpr int V = Lanes<T>::n;
  const int nvec = nc / V;
  const int64_t total = static_cast<int64_t>(nb) * nt * nh * nw * nvec;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += step) {
    const int c0 = static_cast<int>(i % nvec) * V;
    const int64_t pos = i / nvec;  // flat (b, t, h, w)
    int64_t rest = pos;
    const int iw = static_cast<int>(rest % nw);
    rest /= nw;
    const int ih = static_cast<int>(rest % nh);
    rest /= nh;
    const int it = static_cast<int>(rest % nt);
    const int ib = static_cast<int>(rest / nt);

    float acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0.f;

#pragma unroll
    for (int dt = 0; dt < 3; ++dt) {
      const int tt = it + dt - 1;
      if (tt < 0 || tt >= nt) continue;
#pragma unroll
      for (int dh = 0; dh < 3; ++dh) {
        const int hh = ih + dh - 1;
        if (hh < 0 || hh >= nh) continue;
        const int64_t row =
            ((static_cast<int64_t>(ib) * nt + tt) * nh + hh) * nw;
#pragma unroll
        for (int dw = 0; dw < 3; ++dw) {
          const int ww = iw + dw - 1;
          if (ww < 0 || ww >= nw) continue;
          float xv[V], wv[V];
          load16(x + (row + ww) * nc + c0, xv);
          load16(w + (dt * 9 + dh * 3 + dw) * nc + c0, wv);
#pragma unroll
          for (int j = 0; j < V; ++j) acc[j] = fmaf(xv[j], wv[j], acc[j]);
        }
      }
    }
    store16(out + pos * nc + c0, acc);
  }
}

template <typename T>
void launch(const void* x, const void* w, void* out, int nb, int nt, int nh,
            int nw, int nc, cudaStream_t stream) {
  const int64_t total =
      static_cast<int64_t>(nb) * nt * nh * nw * (nc / Lanes<T>::n);
  if (total == 0) return;
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > (1 << 20)) blocks = 1 << 20;  // the loop strides over the rest
  dw3x3x3_fwd_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                          stream>>>(static_cast<const T*>(x),
                                    static_cast<const T*>(w),
                                    static_cast<T*>(out), nb, nt, nh, nw, nc);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x, out: [nb, nt, nh, nw, nc] contiguous,
// 16-byte aligned; w: [3, 3, 3, nc] contiguous, same type; nc % 8 == 0.
extern "C" int pmv_dw3x3x3_fwd(const void* x, const void* w, void* out,
                               int nb, int nt, int nh, int nw, int nc,
                               int dtype, void* stream) {
  if (nc % 8 != 0 || nb < 0 || nt < 0 || nh < 0 || nw < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(x, w, out, nb, nt, nh, nw, nc, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(x, w, out, nb, nt, nh, nw, nc, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
