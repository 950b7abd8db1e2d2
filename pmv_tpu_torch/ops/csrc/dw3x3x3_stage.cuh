// Shared-memory staging for the stride-1 3x3x3 depthwise kernels
// (depthwise3x3x3.cu, depthwise3x3x3_wgrad.cu).
//
// Both kernels cut the channels-last grid [B, T, H, W, C] the same way: a
// block owns one batch entry, a range of `tt` planes of T, a tile of `th`
// rows of H, all of W and a chunk of channels (2^nv_log2 16-byte units per
// position), and walks its planes. It copies the planes it needs next into
// a ring of slots in shared memory, ahead of the plane it works on, each
// with one tensor copy (TMA) that one thread issues: a box of rows x
// columns x one chunk of one plane, whose arrival an mbarrier per slot
// tracks. A box may reach outside the grid (the halo at h0-1, w = -1 and
// beyond the last row and column); the copy fills that part with zeros, so
// no padded copy of x is ever written to device memory, and no thread
// spends instructions on addresses or bounds.
//
// The launch plan (tile rows, chunk, W segments, row pitches, threads and
// shared bytes) is worked out in Python, pmv_tpu_torch/ops/depthwise.py
// (plan_forward, plan_wgrad), where the CPU tests check it; the launchers
// recompute only what they must and refuse an inconsistent plan.
//
// Shared layout of one staged plane: row r holds h = h_first+r, column k
// holds w = w_first+k, and unit u the channels c0 + u*16/size onward: unit
// index r*pitch + k*2^nv_log2 + u, as the box lands. The row pitch, in
// units, is congruent to 2^nv_log2 modulo 8 when a row of one position is
// narrower than 128 bytes, so the rows that one phase of a warp reads fall
// on different banks. Slots start on 128-byte lines.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dw3 {

constexpr int kMaxSmemPerBlock = 232448;  // Hopper's limit for one block
constexpr int kBarrierUnits = 4;  // 16-byte units for up to 8 mbarriers

struct Geometry {
  int nb, nt, nh, nw, nc;  // the grid [B, T, H, W, C]
  int th;                  // rows of H per tile
  int nv_log2;             // log2 of the 16-byte units of a channel chunk
  int nseg, sw;            // W is walked in nseg segments of sw columns
  int pitch;               // 16-byte units per staged x row
  int gpitch;              // 16-byte units per staged g row (wgrad only)
  int tt;                  // planes of T per block
  int nhtiles, nttiles, nchunks;
};

// Block coordinates: H tiles fastest (neighbouring blocks share halo rows
// in L2), then T ranges, then channel chunks, then the batch entry. `row` is
// the block's index among those of its chunk: (b, T range, H tile).
struct Tile {
  int b, row, h0, t0, t1, c0;
};

template <typename T>
__device__ __forceinline__ Tile block_tile(const Geometry& g) {
  constexpr int kPerUnit = 16 / static_cast<int>(sizeof(T));
  int blk = blockIdx.x;
  Tile tile;
  const int htile = blk % g.nhtiles;
  blk /= g.nhtiles;
  const int ttile = blk % g.nttiles;
  blk /= g.nttiles;
  tile.c0 = (blk % g.nchunks) * (kPerUnit << g.nv_log2);
  tile.b = blk / g.nchunks;
  tile.row = (tile.b * g.nttiles + ttile) * g.nhtiles + htile;
  tile.h0 = htile * g.th;
  tile.t0 = ttile * g.tt;
  tile.t1 = min(tile.t0 + g.tt, g.nt);
  return tile;
}

// 16-byte units rounded up to whole 128-byte lines.
__host__ __device__ inline int lines(int units) { return (units + 7) / 8 * 8; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Thread 0 sets up n mbarriers of one arrival each; the block then syncs.
__device__ __forceinline__ void init_barriers(uint64_t* bars, int n) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < n; ++i) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_addr(bars + i))
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// Before their memory is used for anything else.
__device__ __forceinline__ void drop_barriers(uint64_t* bars, int n) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < n; ++i) {
      asm volatile("mbarrier.inval.shared::cta.b64 [%0];\n" ::"r"(
                       smem_addr(bars + i))
                   : "memory");
    }
  }
}

// The box of plane t from `map` whose first row is h, first column w and
// first channel c, into `dst` (128-byte aligned); its `bytes` land on
// `bar`. One thread issues it.
__device__ __forceinline__ void load_box(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, uint32_t bytes, int c,
                                         int w, int h, int t, int b) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.tile.mbarrier::complete_"
      "tx::bytes [%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(w), "r"(h), "r"(t),
      "r"(b), "r"(smem_addr(bar))
      : "memory");
}

// Wait until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void wait_phase(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// N (2 or 4) channels as read from shared or device memory, before
// widening to float32.
template <typename T, int N>
struct Raw;
template <>
struct Raw<float, 4> {
  using type = float4;
};
template <>
struct Raw<float, 2> {
  using type = float2;
};
template <>
struct Raw<__nv_bfloat16, 4> {
  using type = uint2;
};
template <>
struct Raw<__nv_bfloat16, 2> {
  using type = uint32_t;
};

template <typename T, int N>
__device__ __forceinline__ typename Raw<T, N>::type lds_raw(const char* p) {
  return *reinterpret_cast<const typename Raw<T, N>::type*>(p);
}

__device__ __forceinline__ void widen(float4 a, float* v) {
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
}

__device__ __forceinline__ void widen(float2 a, float* v) {
  v[0] = a.x;
  v[1] = a.y;
}

// A bfloat16 is the upper half of a float32, so widening is a shift.
__device__ __forceinline__ void widen(uint32_t a, float* v) {
  v[0] = __uint_as_float(a << 16);
  v[1] = __uint_as_float(a & 0xffff0000u);
}

__device__ __forceinline__ void widen(uint2 a, float* v) {
  widen(a.x, v);
  widen(a.y, v + 2);
}

// N channels from device memory (read-only path), widened to float32.
template <int N, typename T>
__device__ __forceinline__ void ldg(const T* p, float* v) {
  using R = typename Raw<T, N>::type;
  widen(__ldg(reinterpret_cast<const R*>(p)), v);
}

__device__ __forceinline__ uint32_t narrow2(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi)))
          << 16);
}

// 2 channels to device memory, narrowed to T.
__device__ __forceinline__ void store2(float* p, const float* v) {
  *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, const float* v) {
  *reinterpret_cast<uint32_t*>(p) = narrow2(v[0], v[1]);
}

// Checks the launchers share: a plan the kernels can run, on a grid whose
// positions fit the int arithmetic of the tile coordinates. Fills nhtiles,
// nttiles and nchunks. Returns false on an inconsistent plan.
inline bool complete(Geometry& g, int elem_size) {
  const int per_unit = 16 / elem_size;
  if (g.nb < 0 || g.nt < 0 || g.nh < 0 || g.nw < 0 || g.nc <= 0 ||
      g.nc % 8 != 0 || g.th < 1 || g.nv_log2 < 0 || g.nv_log2 > 4 ||
      g.nseg < 1 || g.sw < 1 || g.tt < 1 ||
      static_cast<int64_t>(g.nseg) * g.sw < g.nw ||
      g.nc % (per_unit << g.nv_log2) != 0 ||
      g.pitch < ((g.nw + 2) << g.nv_log2) ||
      static_cast<int64_t>(g.nh) * g.nw >= (int64_t{1} << 30)) {
    return false;
  }
  g.nhtiles = (g.nh + g.th - 1) / g.th;
  g.nttiles = (g.nt + g.tt - 1) / g.tt;
  g.nchunks = g.nc / (per_unit << g.nv_log2);
  return true;
}

// cuTensorMapEncodeTiled, from the driver through the runtime, so the
// libraries need no link to libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// The tensor map of a [nb, nt, nh, nw, nc] tensor at `base` (innermost
// first) read in boxes of box_h rows x box_w columns x one chunk of one
// plane, zeros outside the tensor.
inline cudaError_t tensor_map(CUtensorMap* map, const void* base,
                              const Geometry& g, int elem_size, int box_w,
                              int box_h) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  if (box_w < 1 || box_w > 256 || box_h < 1 || box_h > 256) {
    return cudaErrorInvalidValue;
  }
  const cuuint64_t dims[5] = {
      static_cast<cuuint64_t>(g.nc), static_cast<cuuint64_t>(g.nw),
      static_cast<cuuint64_t>(g.nh), static_cast<cuuint64_t>(g.nt),
      static_cast<cuuint64_t>(g.nb)};
  const cuuint64_t row = static_cast<cuuint64_t>(g.nc) * elem_size;
  const cuuint64_t strides[4] = {row, row * g.nw, row * g.nw * g.nh,
                                 row * g.nw * g.nh * g.nt};
  const cuuint32_t box[5] = {
      static_cast<cuuint32_t>((16 / elem_size) << g.nv_log2),
      static_cast<cuuint32_t>(box_w), static_cast<cuuint32_t>(box_h), 1, 1};
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  const CUresult res = encode(
      map,
      elem_size == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      5, const_cast<void*>(base), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Above the 48 KB default, a kernel's dynamic shared memory must be allowed
// before its launch. The limit is raised to the most a block may take, once
// per kernel and device: setting it waits for the device, so it is kept
// off the launch path (a limit above what a launch uses costs nothing).
// `done` is the kernel's bitmask of devices already set.
inline cudaError_t allow_smem(const void* kernel, int bytes,
                              unsigned long long& done) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (device & 63);
  if (done & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmemPerBlock);
  if (err == cudaSuccess) done |= bit;
  return err;
}

}  // namespace dw3
