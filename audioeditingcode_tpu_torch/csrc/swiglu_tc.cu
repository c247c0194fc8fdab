// Fused SwiGLU projection on Hopper tensor cores, bfloat16, for sm_90a,
// plain C interface.
//
// Replaces audioeditingcode_tpu/ops/swiglu.py::_kernel (host _swiglu_call)
// for bfloat16 inputs; float32 runs in 3xTF32 in swiglu.cu.
// It computes the same function:
//   out[m, n] = (x[m] . W[n] + b[n]) * silu(x[m] . W[N + n] + b[N + n])
// for x (M, E) and the one (2N, E) weight of ff.net.0.proj (value half rows
// [0, N), gate half rows [N, 2N)), both halves read in place. Products
// accumulate in f32; the f32 bias, the SiLU and the product run in f32, and
// the result is rounded once on the store: the (M, 2N) intermediate never
// reaches device memory.
//
// Design. A tile is BM = 128 rows by BN = 128 columns of each half. A
// persistent grid of min(tiles, SMs) blocks of 384 threads walks the tiles
// with a stride of the grid, row blocks fastest: the blocks in flight at
// any time share a few weight column blocks, so the (2N, E) weight is read
// from device memory about once and x stays in L2 (the JAX kernel's "weights
// stream exactly once").
//   - Warpgroup 2 produces: its first thread loads, for every slice of
//     BK = 64 features, the (128 x 64) x tile and the (128 x 64) value and
//     gate weight tiles with TMA (128-byte swizzle) into a 4-stage ring of
//     mbarrier-guarded stages of 48 KB. The value and gate halves are two
//     tensor maps of N rows each, so a half tile past N reads TMA's zero
//     fill, never the other half's rows. It runs on into the next tile's
//     slices while the consumers finish a tile: the ring's stage index and
//     phase carry across tiles and never drain.
//   - Warpgroups 0 and 1 consume, 64 rows each: one m64n256k16 wgmma per 16
//     features from shared memory, both operands K-major as the torch
//     layouts are. The value and gate tiles sit one above the other, so the
//     128-float accumulator holds value columns 0..127 and gate columns
//     128..255 of the same rows in the same thread. A slice is released
//     once the next slice's wgmma group is issued (one group in flight). A
//     consumer whose 64 rows all lie past M (the last row block at M =
//     2050 holds 2 rows) skips its wgmma and still releases its stages.
//   - The epilogue adds the f32 bias, takes a * silu(g) in f32, rounds to
//     bf16 and writes the consumer's 64 x 128 tile, 128-byte swizzled
//     (bank-conflict free), into a 16 KB staging buffer of its own beside
//     the ring, then one thread stores it with two TMA stores, which clip
//     rows past M and columns past N. The buffer is rewritten only after
//     the last tile's store has read it.
// Shared memory: 4 x 48 KB of ring + 2 x 16 KB of staging + 1 KB of
// alignment slack, 225 KB of the 227 KB. Ragged M and an E that is not a
// multiple of BK are TMA's zero fill on the loads. No split over E and no
// atomics: one block writes each output tile, in a fixed order of sums,
// so the result is deterministic.
//
// What bounds it on an H100. At the DiT shape (M = 2 x 1025, E = 1536,
// N = 6144) the function is 4 M E N = 77.4 GFLOP on 69 MB of bf16 input
// and output: 0.078 ms at the 989 TFLOP/s bf16 tensor-core rate, the bound.
// The kernel reaches about half of that rate. Not device memory (the
// weight is read about once) nor, it seems, L2: a tile pulls 1.18 MB of operands
// from L2 for 101 MFLOP, but a variant whose clusters of two blocks
// multicast each weight tile to both, a third less L2 traffic, ran no
// faster (PERF.md). What is left is not measured apart: the epilogue,
// which both consumers run at once while the tensor cores wait; the rounds
// of the persistent grid (816 tiles on 132 SMs leave the last of 7 rounds
// 18 % full, 432 tiles at M = 1025 the last of 4 rounds 27 % full); the
// ring's depth. Consumers that alternate tiles, so that one's epilogue
// overlaps the other's products, are the next step.
//
// Launch errors are returned as cudaGetLastError() to the caller.

#include <limits.h>
#include <math.h>

#include "hopper_tc.cuh"

namespace {

using namespace aec_tc;

constexpr int CONSUMERS = 2;
constexpr int BM = 64 * CONSUMERS;              // rows of x per tile
constexpr int BN = 128;                         // columns per tile, of each half
constexpr int BK = 64;                          // features per stage (128 bytes)
constexpr int THREADS = 128 * (CONSUMERS + 1);  // + the producer warpgroup
constexpr int STAGES = 4;
constexpr int X_TILE = BM * BK * 2;             // 16 KB
constexpr int W_HALF = BN * BK * 2;             // value or gate rows, 16 KB
constexpr int STAGE = X_TILE + 2 * W_HALF;      // 48 KB
constexpr int OUT_BOX = 64 * 64 * 2;            // one TMA store: 64 rows x 64 columns
constexpr int OUT_WG = (BN / 64) * OUT_BOX;     // a consumer's 64 x BN bf16 tile, 16 KB
constexpr int SMEM = STAGES * STAGE + CONSUMERS * OUT_WG + 1024;  // + alignment slack
static_assert(SMEM + 2 * STAGES * 8 <= 232448, "a block takes at most 227 KB of shared memory");

// descriptor of a K-major tile, 128-byte swizzle, 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t desc(const uint8_t* p) {
  return smem_desc(p, 16, 1024, wgmma_layout(128));
}

__device__ __forceinline__ float swiglu(float a, float g) {
  return a * (g * (1.f / (1.f + expf(-g))));
}

__global__ void __launch_bounds__(THREADS, 1)
swiglu_tc_kernel(const __grid_constant__ CUtensorMap xmap,
                 const __grid_constant__ CUtensorMap vmap,
                 const __grid_constant__ CUtensorMap gmap,
                 const __grid_constant__ CUtensorMap omap,
                 const float* __restrict__ bias, int M, int E, int N) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ __align__(8) uint64_t empty[STAGES];
  uint8_t* smem = align1024(smem_raw);

  const int m_blocks = (M + BM - 1) / BM;
  const int tiles = m_blocks * ((N + BN - 1) / BN);
  const int slices = (E + BK - 1) / BK;
  // warpgroup index, broadcast from lane 0 so that the compiler sees it
  // uniform: a wgmma under a branch it deems divergent is serialised
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * 128);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    if (threadIdx.x == CONSUMERS * 128) {
      int it = 0;  // slices loaded by this block, over all its tiles
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile % m_blocks) * BM;  // row blocks fastest
        const int n0 = (tile / m_blocks) * BN;
        for (int t = 0; t < slices; ++t, ++it) {
          const int s = it % STAGES;
          if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) - 1) & 1);
          uint8_t* xs = smem + s * STAGE;
          uint8_t* ws = xs + X_TILE;
          mbar_arrive_expect_tx(&full[s], STAGE);
          tma_load_2d(xs, &xmap, &full[s], t * BK, m0);
          tma_load_2d(ws, &vmap, &full[s], t * BK, n0);
          tma_load_2d(ws + W_HALF, &gmap, &full[s], t * BK, n0);
        }
      }
    }
  } else {
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int r = (tid / 32) * 16 + lane / 4;  // rows r and r + 8 of this consumer's 64
    const int c2 = (lane % 4) * 2;
    uint8_t* out_tile = smem + STAGES * STAGE + wg * OUT_WG;
    float acc[128];  // m64n256: value columns in blocks 0..15, gate in 16..31
    int it = 0;      // slices consumed by this block, over all its tiles
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile % m_blocks) * BM + wg * 64;  // this consumer's first row
      const int n0 = (tile / m_blocks) * BN;
      const bool live = m0 < M;
      for (int t = 0; t < slices; ++t, ++it) {
        const int s = it % STAGES;
        mbar_wait(&full[s], (it / STAGES) & 1);
        if (live) {
          const uint8_t* xs = smem + s * STAGE + wg * (X_TILE / CONSUMERS);
          const uint8_t* ws = smem + s * STAGE + X_TILE;
          fence_operands(acc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk) {
            WgmmaSS<256>::run(acc, desc(xs + kk * 32), desc(ws + kk * 32), t > 0 || kk > 0);
          }
          wgmma_commit();
          wgmma_wait<1>();  // the previous slice's group is done: release its stage
          fence_operands(acc);
        }
        if (t > 0) mbar_arrive(&empty[(it - 1) % STAGES]);
      }
      if (live) {
        wgmma_wait<0>();
        fence_operands(acc);
      }
      mbar_arrive(&empty[(it - 1) % STAGES]);
      if (!live) continue;

      if (tid == 0) bulk_wait_read<0>();  // the last tile's store has read the buffer
      named_barrier(1 + wg, 128);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int n = n0 + 8 * j + c2;
        if (n0 + 8 * j >= N) continue;  // past N: clipped by the store
        const float bv0 = __ldg(bias + n), bv1 = __ldg(bias + n + 1);
        const float bg0 = __ldg(bias + N + n), bg1 = __ldg(bias + N + n + 1);
        uint8_t* box = out_tile + (j / 8) * OUT_BOX;
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int row = r + 8 * x;  // row % 8 == lane / 4
          const uint32_t v = pack_bf16(
              swiglu(acc[4 * j + 2 * x] + bv0, acc[4 * (j + 16) + 2 * x] + bg0),
              swiglu(acc[4 * j + 2 * x + 1] + bv1, acc[4 * (j + 16) + 2 * x + 1] + bg1));
          // 16-byte chunk j % 8 of the row, 128-byte swizzled as the store map reads it
          *reinterpret_cast<uint32_t*>(box + row * 128 + (((j % 8) ^ (lane / 4)) * 16) +
                                       c2 * 2) = v;
        }
      }
      fence_proxy_async();  // the tile's generic writes, before the TMA store reads them
      named_barrier(1 + wg, 128);
      if (tid == 0) {
        tma_store_2d(&omap, out_tile, n0, m0);
        if (n0 + 64 < N) tma_store_2d(&omap, out_tile + OUT_BOX, n0 + 64, m0);
        bulk_commit();
      }
    }
    if (tid == 0) bulk_wait<0>();  // shared memory stays until the stores are done
  }
}

}  // namespace

// bfloat16 x (M, E), w (2N, E) and out (M, N), contiguous and 16-byte
// aligned; bias (2N,) float32. E must be a multiple of 16 and N of 64.
// Returns cudaGetLastError() after the launch, cudaErrorInvalidValue for
// arguments the kernel does not take, or minus the CUDA driver's error when a
// tensor map cannot be encoded (-1: no encoder).
extern "C" int aec_swiglu_tc_fwd(const void* x, const void* w, const void* bias,
                                 void* out, int M, int E, int N, void* stream) {
  if (M < 1 || E < 16 || N < 64 || E % 16 != 0 || N % 64 != 0 ||
      static_cast<int64_t>((M + BM - 1) / BM) * ((N + BN - 1) / BN) > INT_MAX ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
       reinterpret_cast<uintptr_t>(out)) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap xmap, vmap, gmap, omap;
  const cuuint64_t xdims[2] = {(cuuint64_t)E, (cuuint64_t)M};
  const cuuint64_t wdims[2] = {(cuuint64_t)E, (cuuint64_t)N};  // one half
  const cuuint64_t odims[2] = {(cuuint64_t)N, (cuuint64_t)M};
  const cuuint64_t stride[1] = {(cuuint64_t)E * 2};
  const cuuint64_t ostride[1] = {(cuuint64_t)N * 2};
  const cuuint32_t xbox[2] = {BK, BM};
  const cuuint32_t wbox[2] = {BK, BN};
  const cuuint32_t obox[2] = {64, 64};
  const void* gate = static_cast<const uint8_t*>(w) + static_cast<size_t>(N) * E * 2;
  const CUtensorMapDataType bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  int rc = encode_map(&xmap, bf16, 2, x, xdims, stride, xbox, 128);
  if (rc == 0) rc = encode_map(&vmap, bf16, 2, w, wdims, stride, wbox, 128);
  if (rc == 0) rc = encode_map(&gmap, bf16, 2, gate, wdims, stride, wbox, 128);
  if (rc == 0) rc = encode_map(&omap, bf16, 2, out, odims, ostride, obox, 128);
  if (rc != 0) return rc < 0 ? rc : -rc;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(swiglu_tc_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  const int blocks = tiles < sms ? tiles : sms;  // persistent: each walks its tiles
  swiglu_tc_kernel<<<blocks, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      xmap, vmap, gmap, omap, static_cast<const float*>(bias), M, E, N);
  return static_cast<int>(cudaGetLastError());
}
