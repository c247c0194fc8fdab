// Blocked non-causal self-attention on Hopper tensor cores, bfloat16, for
// sm_90a, plain C interface.
//
// Replaces audioeditingcode_tpu/ops/flash_attention.py::_attn_kernel (body
// _attn_core) for bfloat16 inputs; float32 and the rotary variant stay on
// the CUDA-core kernel of flash_attention.cu. It computes the same function
// with the same roundings: o = softmax(q k^T / sqrt(D)) v per (batch, head),
//   - q * scale computed in f32 and rounded to bf16, once per block,
//   - scores, the online softmax and the output accumulator in f32,
//   - p rounded to bf16 before the PV product,
//   - o divided by the softmax sum in f32 and rounded once on the store,
//   - keys at index >= kv_len masked out of the softmax,
//   - grouped-query attention: q head h reads kv head h / (H / H_kv).
// Inputs are (B, S, H, D) bf16 tensors addressed through their strides: the
// last dim contiguous, the base 16-byte aligned and the other strides
// multiples of 8 elements (what TMA takes). D a multiple of 8 up to 128.
//
// Design. A block of 384 threads takes BM = 128 query rows of one (batch,
// head): warpgroups 0 and 1 each own 64 rows, and warpgroup 2 is the
// producer, whose first thread streams K/V tiles of BN keys through a
// 3-stage shared-memory ring with TMA (4-D tensor maps over (D, H_kv, S, B),
// so GQA and strided heads are only coordinates) and mbarriers (a "full"
// barrier per stage that TMA completes, an "empty" one that the 256
// consumer threads release). Each consumer warpgroup keeps its q rows as
// the register A fragments of wgmma (scaled and rounded once), computes
// S = Q K^T with wgmma into f32 registers, runs the online softmax there
// (exponentials as ex2.approx with log2 e folded into the f32 difference,
// as __expf does), rounds P to bf16 in registers and feeds it as the
// register A operand of the PV wgmma, with V read from shared memory
// MN-major (the transpose flag). The two consumer warpgroups are not in
// lock step, so one's softmax overlaps the other's wgmma.
//
// Head dims are padded to a swizzle width, DP in {16, 32, 64, 128}: a K/V
// row of DP bf16 is one 32-, 64- or 128-byte swizzle atom (two 128-byte
// atoms at DP = 128), TMA's out-of-bounds zero fill pads D up to DP and
// the sequence up to a whole tile, and the scores of keys >= kv_len are
// masked in the last tile. Query rows beyond Sq read zeros and are not
// stored. No atomics and a fixed order of every sum: the result is
// deterministic.
//
// What bounds it on an H100. At the UNet's (2, 4096, 8, 16) the function is
// 17.2 GFLOP of bf16 products (0.017 ms at 989 TFLOP/s) and 268 M
// exponentials (0.064 ms on the SFU): the exponentials bound it. At the
// DiT's (2, 1025, 24/12, 64) the products bound it (0.013 ms). This first
// tensor-core version keeps the QK and PV products of one warpgroup in
// series with its softmax; overlapping them inside a warpgroup (issuing
// the next tile's QK before this tile's softmax) and register rebalancing
// with setmaxnreg are left for later.
//
// Launch errors are returned as cudaGetLastError() to the caller.

#include <math.h>

#include "hopper_tc.cuh"

namespace {

using namespace aec_tc;

constexpr int CONSUMERS = 2;                    // warpgroups of 64 query rows
constexpr int BM = 64 * CONSUMERS;              // query rows per block
constexpr int THREADS = 128 * (CONSUMERS + 1);  // + the producer warpgroup
constexpr int STAGES = 3;
constexpr float LOG2E = 1.4426950408889634f;

template <int DP>
struct Cfg {
  static constexpr int W = DP * 2 < 128 ? DP * 2 : 128;  // swizzle width, bytes
  static constexpr int ATOMS = DP * 2 / W;                // column blocks of a row
  static constexpr int BN = DP <= 64 ? 128 : 64;          // keys per tile
  static constexpr int SUB = BN * W;                      // bytes of a column block
  static constexpr int TILE = SUB * ATOMS;                // bytes of a K or V tile
  static constexpr int SMEM = STAGES * 2 * TILE + 1024;   // + alignment slack
  // V's leading offset steps between its two 64-feature column blocks at
  // DP = 128; with one block it is unused and set equal to the stride offset
  static constexpr int LBO_V = ATOMS > 1 ? SUB : 8 * W;
  static_assert(TILE % 1024 == 0, "tiles keep the 1024-byte swizzle alignment");
};

struct Strides {
  int64_t b, s, h;
};

// q row `row` (zero beyond Sq), features d, d + 1 (zero beyond D), times
// scale in f32, rounded to bf16 and packed
__device__ __forceinline__ uint32_t q_pair(const __nv_bfloat16* qp, int row, int Sq,
                                           int d, int D, const Strides& qs, float scale) {
  if (row >= Sq || d >= D) return 0u;
  const __nv_bfloat162 v =
      *reinterpret_cast<const __nv_bfloat162*>(qp + (int64_t)row * qs.s + d);
  const float2 f = __bfloat1622float2(v);
  return pack_bf16(f.x * scale, f.y * scale);
}

template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
attn_tc_kernel(const __grid_constant__ CUtensorMap kmap,
               const __grid_constant__ CUtensorMap vmap,
               const __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ o,
               int H, int rep, int Sq, int kv_len, int D, float scale, Strides qs,
               Strides os) {
  using C = Cfg<DP>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ __align__(8) uint64_t empty[STAGES];
  uint8_t* smem = align1024(smem_raw);

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int tiles = (kv_len + C::BN - 1) / C::BN;
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
    // producer: one thread keeps the ring full
    if (threadIdx.x == CONSUMERS * 128) {
      const int hk = h / rep;
      for (int t = 0; t < tiles; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES) mbar_wait(&empty[s], ((t / STAGES) - 1) & 1);
        uint8_t* kt = smem + s * 2 * C::TILE;
        uint8_t* vt = kt + C::TILE;
        mbar_arrive_expect_tx(&full[s], 2 * C::TILE);
#pragma unroll
        for (int a = 0; a < C::ATOMS; ++a) {
          tma_load_4d(kt + a * C::SUB, &kmap, &full[s], a * (C::W / 2), hk,
                      t * C::BN, b);
          tma_load_4d(vt + a * C::SUB, &vmap, &full[s], a * (C::W / 2), hk,
                      t * C::BN, b);
        }
      }
    }
  } else {
    // consumer warpgroup: rows r and r + 8 of each warp's 16, columns
    // 8 j + c2 and + 1 of every accumulator block j
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int r = blockIdx.y * BM + wg * 64 + (tid / 32) * 16 + lane / 4;
    const int c2 = (lane % 4) * 2;

    uint32_t qf[DP / 16][4];
    {
      const __nv_bfloat16* qp = q + b * qs.b + h * qs.h;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        qf[kk][0] = q_pair(qp, r, Sq, 16 * kk + c2, D, qs, scale);
        qf[kk][1] = q_pair(qp, r + 8, Sq, 16 * kk + c2, D, qs, scale);
        qf[kk][2] = q_pair(qp, r, Sq, 16 * kk + 8 + c2, D, qs, scale);
        qf[kk][3] = q_pair(qp, r + 8, Sq, 16 * kk + 8 + c2, D, qs, scale);
      }
    }

    float acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};

    for (int t = 0; t < tiles; ++t) {
      const int s = t % STAGES;
      mbar_wait(&full[s], (t / STAGES) & 1);
      const uint8_t* kt = smem + s * 2 * C::TILE;
      const uint8_t* vt = kt + C::TILE;

      // S = (q * scale) K^T: K is K-major, 32 bytes (16 features) a step
      float sc[C::BN / 2];
#pragma unroll
      for (int i = 0; i < C::BN / 2; ++i) sc[i] = 0.f;
      fence_operands(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const int byte = kk * 32;
        WgmmaRS<C::BN, 0>::run(
            sc, qf[kk],
            smem_desc(kt + (byte / C::W) * C::SUB + byte % C::W, 16, 8 * C::W,
                      wgmma_layout(C::W)),
            1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(sc);

      const int n0 = t * C::BN;
      if (n0 + C::BN > kv_len) {
#pragma unroll
        for (int i = 0; i < C::BN / 2; ++i) {
          if (n0 + 8 * (i / 4) + c2 + (i & 1) >= kv_len) sc[i] = -INFINITY;
        }
      }

      // online softmax of rows r (elements 4j, 4j+1) and r + 8 (4j+2, 4j+3)
      float mn[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < C::BN / 8; ++j) {
        mn[0] = fmaxf(mn[0], fmaxf(sc[4 * j], sc[4 * j + 1]));
        mn[1] = fmaxf(mn[1], fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        mn[x] = fmaxf(mn[x], __shfl_xor_sync(0xffffffffu, mn[x], 1));
        mn[x] = fmaxf(mn[x], __shfl_xor_sync(0xffffffffu, mn[x], 2));
        // every tile holds a real key, so mn is finite; alpha is 0 at first
        const float alpha = ex2((m[x] - mn[x]) * LOG2E);
        l[x] *= alpha;
#pragma unroll
        for (int j = 0; j < DP / 8; ++j) {
          acc[4 * j + 2 * x] *= alpha;
          acc[4 * j + 2 * x + 1] *= alpha;
        }
        m[x] = mn[x];
      }
      // P in bf16 as the A fragments of the PV product: step kk takes
      // accumulator blocks 2 kk (keys +0..7) and 2 kk + 1 (keys +8..15)
      uint32_t pf[C::BN / 16][4];
#pragma unroll
      for (int kk = 0; kk < C::BN / 16; ++kk) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int j = 2 * kk + half;
          const float p0 = ex2((sc[4 * j] - m[0]) * LOG2E);
          const float p1 = ex2((sc[4 * j + 1] - m[0]) * LOG2E);
          const float p2 = ex2((sc[4 * j + 2] - m[1]) * LOG2E);
          const float p3 = ex2((sc[4 * j + 3] - m[1]) * LOG2E);
          l[0] += p0 + p1;
          l[1] += p2 + p3;
          pf[kk][2 * half] = pack_bf16(p0, p1);
          pf[kk][2 * half + 1] = pack_bf16(p2, p3);
        }
      }

      // O += P V: V is MN-major, 16 keys (16 rows of W bytes) a step
      fence_operands(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C::BN / 16; ++kk) {
        WgmmaRS<DP, 1>::run(acc, pf[kk],
                            smem_desc(vt + kk * 16 * C::W, C::LBO_V, 8 * C::W,
                                      wgmma_layout(C::W)),
                            1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(acc);
      mbar_arrive(&empty[s]);
    }

#pragma unroll
    for (int x = 0; x < 2; ++x) {
      l[x] += __shfl_xor_sync(0xffffffffu, l[x], 1);
      l[x] += __shfl_xor_sync(0xffffffffu, l[x], 2);
    }
    __nv_bfloat16* op = o + b * os.b + h * os.h;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int d = 8 * j + c2;
      if (d >= D) continue;
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int row = r + 8 * x;
        if (row < Sq) {
          const __nv_bfloat162 v = __floats2bfloat162_rn(
              acc[4 * j + 2 * x] / l[x], acc[4 * j + 2 * x + 1] / l[x]);
          *reinterpret_cast<__nv_bfloat162*>(op + (int64_t)row * os.s + d) = v;
        }
      }
    }
  }
}

// K and V tensor maps over (D, H_kv, kv_len, B), tiles of (W / 2, 1, BN, 1)
template <int DP>
int make_maps(CUtensorMap* kmap, CUtensorMap* vmap, const void* k, const void* v,
              int B, int H_kv, int kv_len, int D, const Strides& ks,
              const Strides& vs) {
  using C = Cfg<DP>;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H_kv, (cuuint64_t)kv_len,
                              (cuuint64_t)B};
  const cuuint32_t box[4] = {(cuuint32_t)(C::W / 2), 1, (cuuint32_t)C::BN, 1};
  const cuuint64_t kst[3] = {(cuuint64_t)ks.h * 2, (cuuint64_t)ks.s * 2,
                             (cuuint64_t)ks.b * 2};
  const cuuint64_t vst[3] = {(cuuint64_t)vs.h * 2, (cuuint64_t)vs.s * 2,
                             (cuuint64_t)vs.b * 2};
  int rc = encode_bf16_map(kmap, 4, k, dims, kst, box, C::W);
  if (rc == 0) rc = encode_bf16_map(vmap, 4, v, dims, vst, box, C::W);
  return rc;
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int H_kv, int Sq, int kv_len, int D, float scale, const Strides& qs,
           const Strides& ks, const Strides& vs, const Strides& os,
           cudaStream_t stream) {
  using C = Cfg<DP>;
  CUtensorMap kmap, vmap;
  const int rc = make_maps<DP>(&kmap, &vmap, k, v, B, H_kv, kv_len, D, ks, vs);
  if (rc != 0) return rc < 0 ? rc : -rc;
  cudaError_t err = cudaFuncSetAttribute(
      attn_tc_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (Sq + BM - 1) / BM);
  attn_tc_kernel<DP><<<grid, THREADS, C::SMEM, stream>>>(
      kmap, vmap, static_cast<const __nv_bfloat16*>(q),
      static_cast<__nv_bfloat16*>(o), H, H / H_kv, Sq, kv_len, D, scale, qs, os);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bfloat16 q (B, Sq, H, D), k and v (B, Skv >= kv_len, H_kv, D), o (B, Sq,
// H, D). Strides are in elements; the last dim of every tensor must be
// contiguous, every base 16-byte aligned and every other stride a multiple
// of 8. Returns cudaGetLastError() after the launch, cudaErrorInvalidValue
// for arguments the kernel does not take, or minus the CUDA driver's error when
// a tensor map cannot be encoded (-1: no encoder).
extern "C" int aec_flash_attention_tc_fwd(
    const void* q, const void* k, const void* v, void* o, int B, int H, int H_kv,
    int Sq, int kv_len, int D, float scale, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_ss, long long o_sh,
    void* stream) {
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh},
      os{o_sb, o_ss, o_sh};
  if (B < 1 || H < 1 || H_kv < 1 || H % H_kv != 0 || Sq < 1 || kv_len < 1 ||
      D < 8 || D > 128 || D % 8 != 0 || (Sq + BM - 1) / BM > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
  const long long strides = q_sb | q_ss | q_sh | k_sb | k_ss | k_sh | v_sb | v_ss |
                            v_sh | o_sb | o_ss | o_sh;
  if (bases % 16 != 0 || strides % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 16) {
    return launch<16>(q, k, v, o, B, H, H_kv, Sq, kv_len, D, scale, qs, ks, vs, os, st);
  }
  if (D <= 32) {
    return launch<32>(q, k, v, o, B, H, H_kv, Sq, kv_len, D, scale, qs, ks, vs, os, st);
  }
  if (D <= 64) {
    return launch<64>(q, k, v, o, B, H, H_kv, Sq, kv_len, D, scale, qs, ks, vs, os, st);
  }
  return launch<128>(q, k, v, o, B, H, H_kv, Sq, kv_len, D, scale, qs, ks, vs, os, st);
}
