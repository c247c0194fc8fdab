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
// Design. A block of 384 threads owns BM = 128 rows and BN = 64 columns of
// each half. Warpgroup 2 is the producer: its first thread loads, for every
// slice of BK = 64 features, the (128 x 64) x tile and the two (64 x 64)
// weight tiles at rows n0 and N + n0 with TMA into a 4-stage ring of
// mbarrier-guarded shared-memory stages (128-byte swizzle). The two weight
// tiles sit one above the other, so each consumer warpgroup (64 rows) runs
// one m64n128k16 wgmma per 16 features from shared memory, both operands
// K-major as the torch layouts already are, and its f32 accumulator holds
// value columns 0..63 and gate columns 64..127 of the same rows in the same
// thread. A slice is released once the wgmma group of the next slice has
// been issued (one group in flight). The epilogue reads the bias once per
// tile and stores bf16 pairs. Ragged M and an E that is not a multiple of
// BK are TMA's zero fill on the loads; stores are clipped to M. BN = 64 per
// half matches the wrapper's N % 64 == 0, so no half tile is masked. No
// split over E, no atomics: the result is deterministic.
//
// What bounds it on an H100. At the DiT shape (M = 2 x 1025, E = 1536,
// N = 6144) the function is 4 M E N = 77.4 GFLOP on 69 MB of bf16 input and
// output: 0.078 ms at the 989 TFLOP/s bf16 tensor-core rate, the bound. The
// grid is 96 x 17 = 1632 blocks, one per SM at a time; a persistent tile
// scheduler that overlaps one tile's epilogue with the next one's loads is
// left for later.
//
// Launch errors are returned as cudaGetLastError() to the caller.

#include <math.h>

#include "hopper_tc.cuh"

namespace {

using namespace aec_tc;

constexpr int CONSUMERS = 2;
constexpr int BM = 64 * CONSUMERS;              // rows of x per block
constexpr int BN = 64;                          // columns per block, of each half
constexpr int BK = 64;                          // features per stage (128 bytes)
constexpr int THREADS = 128 * (CONSUMERS + 1);  // + the producer warpgroup
constexpr int STAGES = 4;
constexpr int X_TILE = BM * BK * 2;             // 16 KB
constexpr int W_TILE = 2 * BN * BK * 2;         // value and gate tiles, 16 KB
constexpr int STAGE = X_TILE + W_TILE;
constexpr int SMEM = STAGES * STAGE + 1024;     // + alignment slack

__global__ void __launch_bounds__(THREADS, 1)
swiglu_tc_kernel(const __grid_constant__ CUtensorMap xmap,
                 const __grid_constant__ CUtensorMap wmap,
                 const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                 int M, int E, int N) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ __align__(8) uint64_t empty[STAGES];
  uint8_t* smem = align1024(smem_raw);

  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int slices = (E + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

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
      for (int t = 0; t < slices; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES) mbar_wait(&empty[s], ((t / STAGES) - 1) & 1);
        uint8_t* xs = smem + s * STAGE;
        uint8_t* ws = xs + X_TILE;
        mbar_arrive_expect_tx(&full[s], STAGE);
        tma_load_2d(xs, &xmap, &full[s], t * BK, m0);
        tma_load_2d(ws, &wmap, &full[s], t * BK, n0);
        tma_load_2d(ws + W_TILE / 2, &wmap, &full[s], t * BK, N + n0);
      }
    }
  } else {
    float acc[64];  // m64n128: value columns in blocks 0..7, gate in 8..15
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;

    for (int t = 0; t < slices; ++t) {
      const int s = t % STAGES;
      mbar_wait(&full[s], (t / STAGES) & 1);
      const uint8_t* xs = smem + s * STAGE + wg * (X_TILE / CONSUMERS);
      const uint8_t* ws = smem + s * STAGE + X_TILE;
      fence_operands(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        WgmmaSS<128>::run(acc, smem_desc(xs + kk * 32, 16, 1024, wgmma_layout(128)),
                          smem_desc(ws + kk * 32, 16, 1024, wgmma_layout(128)), 1);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous slice's group is done: release its stage
      fence_operands(acc);
      if (t > 0) mbar_arrive(&empty[(t - 1) % STAGES]);
    }
    wgmma_wait<0>();
    fence_operands(acc);

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
        *reinterpret_cast<__nv_bfloat162*>(out + (int64_t)row * N + n) =
            __floats2bfloat162_rn(a0 * (g0 * (1.f / (1.f + expf(-g0)))),
                                  a1 * (g1 * (1.f / (1.f + expf(-g1)))));
      }
    }
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
  if (M < 1 || E < 16 || N < BN || E % 16 != 0 || N % BN != 0 ||
      (M + BM - 1) / BM > 65535 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
       reinterpret_cast<uintptr_t>(out)) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap xmap, wmap;
  const cuuint64_t xdims[2] = {(cuuint64_t)E, (cuuint64_t)M};
  const cuuint64_t wdims[2] = {(cuuint64_t)E, (cuuint64_t)(2 * N)};
  const cuuint64_t stride[1] = {(cuuint64_t)E * 2};
  const cuuint32_t xbox[2] = {BK, BM};
  const cuuint32_t wbox[2] = {BK, BN};
  const CUtensorMapDataType bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  int rc = encode_map(&xmap, bf16, 2, x, xdims, stride, xbox, 128);
  if (rc == 0) rc = encode_map(&wmap, bf16, 2, w, wdims, stride, wbox, 128);
  if (rc != 0) return rc < 0 ? rc : -rc;
  const cudaError_t err = cudaFuncSetAttribute(
      swiglu_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(N / BN, (M + BM - 1) / BM);
  swiglu_tc_kernel<<<grid, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      xmap, wmap, static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out),
      M, E, N);
  return static_cast<int>(cudaGetLastError());
}
