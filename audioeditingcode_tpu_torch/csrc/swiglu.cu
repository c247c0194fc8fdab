// Fused SwiGLU projection in float32 on Hopper tensor cores, with the
// products in 3xTF32, for sm_90a, plain C interface.
//
// Replaces audioeditingcode_tpu/ops/swiglu.py::_kernel (host _swiglu_call,
// dispatcher fused_swiglu) for float32 inputs; bfloat16 runs in
// swiglu_tc.cu. It computes the same function:
//   out[m, n] = (x[m] . W[n] + b[n]) * silu(x[m] . W[N + n] + b[N + n])
// for x (M, E) and the one (2N, E) weight of the DiT feed-forward's
// ff.net.0.proj Linear (torch layout: the value half is rows [0, N), the
// gate half rows [N, 2N)). Both halves are read from that weight in place,
// as the Pallas kernel passes the weight twice with two index maps.
// Products are summed in f32; the f32 bias, the SiLU and the product run in
// f32, and the result is stored once: the (M, 2N) intermediate never
// reaches device memory.
//
// Products in 3xTF32. x and W are split into TF32 parts hi + lo (tf32.cuh)
// and each product is taken on the tensor cores as lo_x hi_w + hi_x lo_w +
// hi_x hi_w, which keeps float32 accuracy where one TF32 product does not
// (tests/test_torch_swiglu.py). The tensor cores truncate each sum they add
// into an accumulator, so one chain of them over all of E drifts toward
// zero, past the float32 tolerance at E = 1536. So each stage of BK = 32
// features is summed in a stage accumulator that starts fresh (the stage's
// first wgmma ignores the old value) and is added into the running f32 sum
// with rounded adds: no truncating chain covers more than 32 features.
//
// Design. A block of 384 threads owns BM = 128 rows and BN = 64 columns of
// each half. Warpgroups 0 and 1 consume, 64 rows each; warpgroup 2
// produces.
//   - Producer thread 0 loads, for every slice of BK = 32 features (128
//     bytes of f32), the (128 x 32) x tile and the two (64 x 32) weight
//     tiles at rows n0 and N + n0 with TMA (128-byte swizzle) into a
//     3-stage ring of mbarrier-guarded shared-memory stages.
//   - Producer warps 1-3 split each stage once it lands: the split is
//     elementwise, so they walk the stage's 32 KB linearly whatever the
//     swizzle, write hi over the loaded tile and lo into a twin buffer of
//     the same layout, then fence.proxy.async (wgmma reads in the async
//     proxy) and arrive on the stage's "ready" mbarrier. Each element is
//     split once per block, not once per warp that reads it.
//   - Each consumer runs, per stage, 4 k8 steps of three wgmma m64n128k8
//     from shared memory, both operands K-major as x and W are stored (tf32
//     wgmma takes no other layout), into a stage accumulator; it waits for
//     the group, adds the stage sum into its running sum and releases the
//     stage. The two weight tiles sit one above the other, so the
//     accumulators hold value columns 0..63 and gate columns 64..127 of the
//     same rows in the same thread: 128 floats a thread, 146 registers, no
//     spill. While one consumer waits and adds, the other's wgmma can keep
//     the tensor cores busy. Keeping a second stage's group in flight (a
//     third accumulator) spilled and was slower on the H100, and so was
//     summing the small terms in an accumulator of their own, which did
//     not lower the error (PERF.md).
//   - The epilogue reads the bias once per tile and stores float2 pairs,
//     clipped to M.
// Ragged M and an E that is not a multiple of BK are TMA's zero fill.
// BN = 64 per half matches the wrapper's N % 64 == 0. No split over E and
// no atomics: the result is deterministic. Row blocks run along grid x, so
// the row blocks of one weight column block run together and share its
// tiles in L2: the f32 weight (75 MB at the DiT shape) does not fit the
// 50 MB L2, and this order reads it from device memory about once.
//
// What bounds it on an H100. At the DiT shape (M = 2 x 1025, E = 1536,
// N = 6144) the function is 4 M E N = 77.4 GFLOP on 138 MB of f32 input
// and output. As three TF32 products that is 232 GFLOP: 0.469 ms at the
// 495 TFLOP/s TF32 peak, the least time at float32 accuracy (one f32 FMA
// product on the CUDA cores: 1.155 ms at 67 TFLOP/s).
//
// Routes (ops/swiglu.py::swiglu_route): float32 runs here; bfloat16 runs
// on the tensor cores in swiglu_tc.cu.
//
// Launch errors are returned as cudaGetLastError() to the caller.

#include <math.h>

#include "hopper_tc.cuh"
#include "tf32.cuh"

namespace {

using namespace aec_tc;

constexpr int CONSUMERS = 2;
constexpr int BM = 64 * CONSUMERS;              // rows of x per block
constexpr int BN = 64;                          // columns per block, of each half
constexpr int BK = 32;                          // features per stage (128 bytes)
constexpr int THREADS = 128 * (CONSUMERS + 1);  // + the producer warpgroup
constexpr int SPLITTERS = 96;                   // producer warps 1-3
constexpr int STAGES = 3;
constexpr int X_TILE = BM * BK * 4;             // 16 KB
constexpr int W_TILE = 2 * BN * BK * 4;         // value and gate tiles, 16 KB
constexpr int RAW = X_TILE + W_TILE;            // what TMA lands, then hi
constexpr int STAGE = 2 * RAW;                  // + the lo twin
constexpr int SMEM = STAGES * STAGE + 1024;     // + alignment slack
static_assert(SMEM <= 232448, "a block takes at most 227 KB of shared memory");

// descriptor of a K-major tile, 128-byte swizzle, 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t desc(const uint8_t* p) {
  return smem_desc(p, 16, 1024, wgmma_layout(128));
}

// Issue one stage's products for this consumer's 64 rows into d, a fresh
// sum, as one committed wgmma group: per k8 step lo_x hi_w + hi_x lo_w +
// hi_x hi_w (hi at `stage`, lo RAW bytes above it).
__device__ __forceinline__ void stage_products(float (&d)[64], const uint8_t* stage,
                                               int wg) {
  const uint8_t* xh = stage + wg * (X_TILE / CONSUMERS);
  const uint8_t* wh = stage + X_TILE;
  fence_operands(d);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
    const int k = kk * 32;  // bytes: 8 features
    WgmmaTf32SS<128>::run(d, desc(xh + RAW + k), desc(wh + k), kk > 0);
    WgmmaTf32SS<128>::run(d, desc(xh + k), desc(wh + RAW + k), 1);
    WgmmaTf32SS<128>::run(d, desc(xh + k), desc(wh + k), 1);
  }
  wgmma_commit();
}

__global__ void __launch_bounds__(THREADS, 1)
swiglu_tf32x3_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap wmap,
                     const float* __restrict__ bias, float* __restrict__ out, int M,
                     int E, int N) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES];   // the stage's tiles landed
  __shared__ __align__(8) uint64_t ready[STAGES];  // ... and are split
  __shared__ __align__(8) uint64_t empty[STAGES];  // ... and are consumed
  uint8_t* smem = align1024(smem_raw);

  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int slices = (E + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&ready[s], SPLITTERS);
      mbar_init(&empty[s], CONSUMERS * 128);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    const int tid = threadIdx.x - CONSUMERS * 128;
    if (tid == 0) {
      for (int t = 0; t < slices; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES) mbar_wait(&empty[s], ((t / STAGES) - 1) & 1);
        uint8_t* xs = smem + s * STAGE;
        uint8_t* ws = xs + X_TILE;
        mbar_arrive_expect_tx(&full[s], RAW);
        tma_load_2d(xs, &xmap, &full[s], t * BK, m0);
        tma_load_2d(ws, &wmap, &full[s], t * BK, n0);
        tma_load_2d(ws + W_TILE / 2, &wmap, &full[s], t * BK, N + n0);
      }
    } else if (tid >= 32) {
      for (int t = 0; t < slices; ++t) {
        const int s = t % STAGES;
        mbar_wait(&full[s], (t / STAGES) & 1);
        float4* hi = reinterpret_cast<float4*>(smem + s * STAGE);
        float4* lo = reinterpret_cast<float4*>(smem + s * STAGE + RAW);
        for (int i = tid - 32; i < RAW / 16; i += SPLITTERS) {
          const float4 v = hi[i];
          uint32_t h[4], l[4];
          split(v.x, h[0], l[0]);
          split(v.y, h[1], l[1]);
          split(v.z, h[2], l[2]);
          split(v.w, h[3], l[3]);
          hi[i] = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                              __uint_as_float(h[2]), __uint_as_float(h[3]));
          lo[i] = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                              __uint_as_float(l[2]), __uint_as_float(l[3]));
        }
        fence_proxy_async();  // the consumers' wgmma reads hi and lo
        mbar_arrive(&ready[s]);
      }
    }
  } else {
    float acc[64];  // m64n128: value columns in blocks 0..7, gate in 8..15
    float part[64];  // one stage's sum
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;

    for (int t = 0; t < slices; ++t) {
      const int s = t % STAGES;
      mbar_wait(&ready[s], (t / STAGES) & 1);
      stage_products(part, smem + s * STAGE, wg);
      wgmma_wait<0>();
      fence_operands(part);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += part[i];  // rounded f32 adds
      mbar_arrive(&empty[s]);
    }

    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int r = m0 + wg * 64 + (tid / 32) * 16 + lane / 4;
    const int c2 = (lane % 4) * 2;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + 8 * j + c2;
      const float bv0 = __ldg(bias + n), bv1 = __ldg(bias + n + 1);
      const float bg0 = __ldg(bias + N + n), bg1 = __ldg(bias + N + n + 1);
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int row = r + 8 * x;
        if (row >= M) continue;
        const float a0 = acc[4 * j + 2 * x] + bv0;
        const float a1 = acc[4 * j + 2 * x + 1] + bv1;
        const float g0 = acc[4 * (j + 8) + 2 * x] + bg0;
        const float g1 = acc[4 * (j + 8) + 2 * x + 1] + bg1;
        *reinterpret_cast<float2*>(out + (int64_t)row * N + n) =
            make_float2(a0 * (g0 * (1.f / (1.f + expf(-g0)))),
                        a1 * (g1 * (1.f / (1.f + expf(-g1)))));
      }
    }
  }
}

}  // namespace

// float32 x (M, E), w (2N, E), bias (2N,) and out (M, N), contiguous; x, w
// and out 16-byte aligned. E must be a multiple of 16 and N of 64. Returns
// cudaGetLastError() after the launch, cudaErrorInvalidValue for arguments
// the kernel does not take, or minus the CUDA driver's error when a tensor
// map cannot be encoded (-1: no encoder).
extern "C" int aec_swiglu_fwd(const void* x, const void* w, const void* bias,
                              void* out, int M, int E, int N, void* stream) {
  if (M < 1 || E < 16 || N < BN || E % 16 != 0 || N % BN != 0 || N / BN > 65535 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
       reinterpret_cast<uintptr_t>(out)) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap xmap, wmap;
  const cuuint64_t xdims[2] = {(cuuint64_t)E, (cuuint64_t)M};
  const cuuint64_t wdims[2] = {(cuuint64_t)E, (cuuint64_t)(2 * N)};
  const cuuint64_t stride[1] = {(cuuint64_t)E * 4};
  const cuuint32_t xbox[2] = {BK, BM};
  const cuuint32_t wbox[2] = {BK, BN};
  const CUtensorMapDataType f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  int rc = encode_map(&xmap, f32, 2, x, xdims, stride, xbox, 128);
  if (rc == 0) rc = encode_map(&wmap, f32, 2, w, wdims, stride, wbox, 128);
  if (rc != 0) return rc < 0 ? rc : -rc;
  const cudaError_t err = cudaFuncSetAttribute(
      swiglu_tf32x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((M + BM - 1) / BM, N / BN);
  swiglu_tf32x3_kernel<<<grid, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      xmap, wmap, static_cast<const float*>(bias), static_cast<float*>(out), M, E, N);
  return static_cast<int>(cudaGetLastError());
}
