// Fused SwiGLU projection in float32 on the CUDA cores, for Hopper
// (sm_90a), plain C interface.
//
// Replaces audioeditingcode_tpu/ops/swiglu.py::_kernel (host _swiglu_call,
// dispatcher fused_swiglu). It computes the same function:
//   out[m, n] = (x[m] . W[n] + b[n]) * silu(x[m] . W[N + n] + b[N + n])
// for x (M, E) and the one (2N, E) weight of the DiT feed-forward's
// ff.net.0.proj Linear (torch layout: the value half is rows [0, N), the
// gate half rows [N, 2N)). Both halves are read from that weight in place,
// with no copy, as the Pallas kernel passes the kernel twice with two index
// maps. Products accumulate in f32, the bias is added in f32, SiLU and the
// product run in f32, and the tile is stored once: the (M, 2N)
// intermediate never reaches device memory. Each output is summed in k
// order with FMAs, as cuBLAS's FFMA GEMM does, so it is bit-equal to the
// plain version's float32 matmul plus epilogue.
//
// Blocking. The TPU kernel keeps all M rows of x resident in VMEM and
// streams the weight once. A Hopper block has 227 KB of shared memory, so
// here each block owns one BM x BN output tile of both halves and walks E
// in BK slices: the x slice (BM x BK) and the two weight slices (BN x BK
// each) are staged through shared memory, stored k-major (transposed) so
// that each thread reads its rows and columns as float4 broadcasts. Each of
// the 256 threads keeps an 8 x 4 register micro-tile of BOTH accumulators
// (value and gate, 64 floats) and issues 64 FMAs for every four 16-byte
// shared loads. The next slice's global loads are issued before the current
// slice's FMAs (register prefetch), so their latency hides behind compute.
// Ragged M is masked in the kernel (loads read zeros, stores are skipped),
// so no padding copy is made; E must be a multiple of BK and N of BN.
//
// What bounds it on an H100. At the DiT shape (M = 2 x 1025, E = 1536,
// N = 6144) the function is 4 M E N = 77.4 GFLOP on ~139 MB of f32 inputs
// and output: it is bound by operations, not bytes (1.16 ms at the 67
// TFLOP/s f32 FMA rate). This kernel runs the products on the CUDA cores
// in f32, so its bound is the f32 FMA rate.
//
// Routes (ops/swiglu.py::swiglu_route): float32 runs here; bfloat16 runs
// on the tensor cores in swiglu_tc.cu (TMA, mbarriers, wgmma).
//
// Launch errors are returned as cudaGetLastError() to the caller.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;  // rows of x per block
constexpr int BN = 64;   // output columns per block (of each half)
constexpr int BK = 16;   // slice of E staged per step
constexpr int TM = 8;    // rows per thread
constexpr int TN = 4;    // columns per thread (of each half)
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
constexpr int PAD = 4;   // keeps float4 alignment, spreads the transposed stores

static_assert(THREADS == 256, "the load mapping assumes 256 threads");
static_assert(BM * BK == 2 * 4 * THREADS, "two 4-wide x loads per thread");
static_assert(BN * BK == 4 * THREADS, "one 4-wide load per weight half per thread");

// four consecutive floats from global memory
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__global__ void __launch_bounds__(THREADS)
swiglu_kernel(const float* __restrict__ x, const float* __restrict__ w,
              const float* __restrict__ bias, float* __restrict__ out, int M,
              int E, int N) {
  __shared__ __align__(16) float xs[BK][BM + PAD];
  __shared__ __align__(16) float vs[BK][BN + PAD];
  __shared__ __align__(16) float gs[BK][BN + PAD];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  // global -> register mapping: 4 consecutive k of one row per load
  const int lrow = tid / (BK / 4);       // 0..63
  const int lk = (tid % (BK / 4)) * 4;   // 0, 4, 8, 12
  const int xr0 = m0 + lrow;
  const int xr1 = m0 + lrow + BM / 2;
  const bool x0_ok = xr0 < M;
  const bool x1_ok = xr1 < M;
  const float* xp0 = x + (int64_t)(x0_ok ? xr0 : 0) * E + lk;
  const float* xp1 = x + (int64_t)(x1_ok ? xr1 : 0) * E + lk;
  const float* vp = w + (int64_t)(n0 + lrow) * E + lk;
  const float* gp = w + (int64_t)(N + n0 + lrow) * E + lk;

  // compute mapping: rows ty*TM .. +7, columns tx*TN .. +3 of each half
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);

  float acc_v[TM][TN];
  float acc_g[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      acc_v[i][j] = 0.f;
      acc_g[i][j] = 0.f;
    }
  }

  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 rx0 = x0_ok ? load4(xp0) : zero4;
  float4 rx1 = x1_ok ? load4(xp1) : zero4;
  float4 rv = load4(vp);
  float4 rg = load4(gp);

  for (int k0 = 0; k0 < E; k0 += BK) {
    __syncthreads();  // every thread is done with the previous slice
    xs[lk + 0][lrow] = rx0.x;
    xs[lk + 1][lrow] = rx0.y;
    xs[lk + 2][lrow] = rx0.z;
    xs[lk + 3][lrow] = rx0.w;
    xs[lk + 0][lrow + BM / 2] = rx1.x;
    xs[lk + 1][lrow + BM / 2] = rx1.y;
    xs[lk + 2][lrow + BM / 2] = rx1.z;
    xs[lk + 3][lrow + BM / 2] = rx1.w;
    vs[lk + 0][lrow] = rv.x;
    vs[lk + 1][lrow] = rv.y;
    vs[lk + 2][lrow] = rv.z;
    vs[lk + 3][lrow] = rv.w;
    gs[lk + 0][lrow] = rg.x;
    gs[lk + 1][lrow] = rg.y;
    gs[lk + 2][lrow] = rg.z;
    gs[lk + 3][lrow] = rg.w;
    __syncthreads();

    if (k0 + BK < E) {  // prefetch the next slice while this one computes
      const int off = k0 + BK;
      rx0 = x0_ok ? load4(xp0 + off) : zero4;
      rx1 = x1_ok ? load4(xp1 + off) : zero4;
      rv = load4(vp + off);
      rg = load4(gp + off);
    }

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&xs[kk][ty * TM]);
      const float4 a1 = *reinterpret_cast<const float4*>(&xs[kk][ty * TM + 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&vs[kk][tx * TN]);
      const float4 bg = *reinterpret_cast<const float4*>(&gs[kk][tx * TN]);
      const float a[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float v[TN] = {bv.x, bv.y, bv.z, bv.w};
      const float g[TN] = {bg.x, bg.y, bg.z, bg.w};
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc_v[i][j] = fmaf(a[i], v[j], acc_v[i][j]);
          acc_g[i][j] = fmaf(a[i], g[j], acc_g[i][j]);
        }
      }
    }
  }

  // epilogue: bias, SiLU and product in f32, one rounding on the store
  const int n = n0 + tx * TN;
  float bv[TN], bg[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    bv[j] = __ldg(bias + n + j);
    bg[j] = __ldg(bias + N + n + j);
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) break;
    float o[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const float a = acc_v[i][j] + bv[j];
      const float g = acc_g[i][j] + bg[j];
      o[j] = a * (g * (1.f / (1.f + expf(-g))));
    }
    *reinterpret_cast<float4*>(out + (int64_t)m * N + n) =
        make_float4(o[0], o[1], o[2], o[3]);
  }
}

}  // namespace

// float32 x (M, E), w (2N, E), bias (2N,) and out (M, N), all contiguous
// and 16-byte aligned. E must be a multiple of 16 and N of 64. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for arguments
// the kernel does not take).
extern "C" int aec_swiglu_fwd(const void* x, const void* w, const void* bias,
                              void* out, int M, int E, int N, void* stream) {
  if (M < 1 || E < BK || N < BN || E % BK != 0 || N % BN != 0 ||
      (M + BM - 1) / BM > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(N / BN, (M + BM - 1) / BM);
  swiglu_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(out), M, E, N);
  return static_cast<int>(cudaGetLastError());
}
