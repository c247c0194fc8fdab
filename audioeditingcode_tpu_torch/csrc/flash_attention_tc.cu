// Blocked non-causal self-attention on Hopper tensor cores, bfloat16, for
// sm_90a, plain C interface.
//
// Replaces audioeditingcode_tpu/ops/flash_attention.py::_attn_kernel (body
// _attn_core) and, as its ROT variant, _attn_rotary_kernel (with _rotate),
// for bfloat16 inputs; float32 runs in 3xTF32 in flash_attention.cu. It
// computes the same function with the same roundings: o = softmax(q k^T /
// sqrt(D)) v per (batch, head),
//   - q * scale computed in f32 and rounded to bf16, once per block,
//   - scores, the online softmax and the output accumulator in f32,
//   - p rounded to bf16 before the PV product,
//   - o divided by the softmax sum in f32 and rounded once on the store,
//   - keys at index >= kv_len masked out of the softmax,
//   - grouped-query attention: q head h reads kv head h / (H / H_kv).
// Inputs are (B, S, H, D) bf16 tensors addressed through their strides: the
// last dim contiguous, the base 16-byte aligned and the other strides
// multiples of 8 elements (what TMA takes). D a multiple of 8 up to 256, in
// both variants (the wrapper zero-pads other head dims to the next multiple
// of 8 and passes the scale of the true D).
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
// Head dims are padded to a swizzle width, DP in {16, 32, 64, 128, 192, 256}:
// a K/V row of DP bf16 is one 32-, 64- or 128-byte swizzle atom (two
// 128-byte atoms at DP = 128, three at 192, four at 256), TMA's
// out-of-bounds zero fill pads D up to DP (136-184 to 192, 200-248 to 256)
// and
// the sequence up to a whole tile, and the scores of keys >= kv_len are
// masked in the last tile. Query rows beyond Sq read zeros and are not
// stored. At DP = 192 a consumer thread holds 96 accumulators, 48 q
// registers and a 64-key tile's scores and P: more than the 168 registers
// a thread of 384 may have, so that instance runs one consumer warpgroup
// (BM = 64, 256 threads, up to 255 registers) and its PV product as three
// m64n64 wgmma, one per 128-byte column block of V. At DP = 256 the block's
// V columns are split: a grid axis over DV = 128-feature column blocks, each
// block computing the whole S = q K^T over all 256 features and the PV
// product (one m64n128 wgmma a step, as at DP = 128) for its own columns,
// so its accumulators and V tile keep DP = 128 sizes for the price of one
// extra q K^T. The blocks of one row block run the same QK sums in the same
// order, so their softmax statistics agree bit for bit. No atomics and a
// fixed order of every sum: the result is deterministic.
//
// Rotary variant (ROT, the Stable Audio DiT's attn1 behind
// AEC_ROTARY_IN_KERNEL=1): a rotate-half rotary embedding is applied in f32
// to the first `rot` features of q and of k, from (S, rot) f32 cos/sin
// tables indexed by position, with the products and their sum rounded
// separately (no FMA contraction, as the plain PyTorch version computes
// them), and the result is rounded to bf16 before anything else touches it,
// as _rotate does. Each consumer thread rotates its q features as it loads
// them (the partner feature d +- rot/2 read from global memory), before the
// q * scale rounding. Each K tile is rotated in shared memory after TMA has
// landed it and before any QK wgmma reads it: the producer warpgroup's
// warps 1-3 wait on the stage's "full" barrier, each thread takes whole
// (d, d + rot/2) pairs, or 16-byte chunks of 8 pairs where rot % 16 == 0,
// of the tile's real keys (rows past kv_len are TMA's zero fill, masked
// anyway, and would index the tables past their end),
// reads and writes them through the swizzle TMA wrote, fences its writes
// for the async proxy and arrives on the stage's "rotated" barrier, which
// the consumers wait on besides "full". The rotated q and k never reach
// device memory. Square self-attention only; rot even and <= D.
//
// What bounds it on an H100. At the UNet's (2, 4096, 8, 16) the function is
// 17.2 GFLOP of bf16 products (0.017 ms at 989 TFLOP/s) and 268 M
// exponentials (0.064 ms on the SFU): the exponentials bound it. At the
// DiT's (2, 1025, 24/12, 64) the products bound it (0.013 ms). This first
// tensor-core version keeps the QK and PV products of one warpgroup in
// series with its softmax; overlapping them inside a warpgroup (issuing
// the next tile's QK before this tile's softmax) and register rebalancing
// with setmaxnreg are left for later. The ROT variant adds no product,
// only instructions: its K-tile rotation (BN x rot/2 pairs a tile) runs on
// the producer's three otherwise idle warps while the consumers work on
// the tiles before it, which hides it only while it needs fewer instruction
// slots than a consumer tile (hence the 16-byte chunks); the q rotation
// runs once per block, before the first tile.
//
// Launch errors are returned as cudaGetLastError() to the caller.

#include <math.h>

#include "hopper_tc.cuh"

namespace {

using namespace aec_tc;

constexpr int STAGES = 3;
constexpr int ROTATORS = 96;  // the producer warpgroup's warps 1-3 (ROT)
constexpr float LOG2E = 1.4426950408889634f;

// DP: the padded width of q and K; DV: the V and output columns of one
// block (DV = DP, or 128 of DP = 256)
template <int DP, int DV>
struct Cfg {
  static constexpr int CONSUMERS = DP > 128 ? 1 : 2;      // warpgroups of 64 query rows
  static constexpr int BM = 64 * CONSUMERS;               // query rows per block
  static constexpr int THREADS = 128 * (CONSUMERS + 1);   // + the producer warpgroup
  static constexpr int W = DP * 2 < 128 ? DP * 2 : 128;  // swizzle width, bytes
  static constexpr int ATOMS = DP * 2 / W;                // column blocks of a K row
  static constexpr int ATOMS_V = DV * 2 / W;              // column blocks of a V row
  static constexpr int BN = DP <= 64 ? 128 : 64;          // keys per tile
  static constexpr int SUB = BN * W;                      // bytes of a column block
  static constexpr int TILE = SUB * ATOMS;                // bytes of a K tile
  static constexpr int TILE_V = SUB * ATOMS_V;            // bytes of a V tile
  static constexpr int STAGE = TILE + TILE_V;
  static constexpr int SMEM = STAGES * STAGE + 1024;      // + alignment slack
  // V's leading offset steps between its two 64-feature column blocks at
  // DV = 128; with one block (and at DV = 192, whose PV product takes one
  // block a wgmma) it is unused and set equal to the stride offset
  static constexpr int LBO_V = ATOMS_V == 2 ? SUB : 8 * W;
  static_assert(DP % DV == 0 && (DV == DP || DV == 128), "V column blocks");
  static_assert(TILE % 1024 == 0 && TILE_V % 1024 == 0,
                "tiles keep the 1024-byte swizzle alignment");
};

struct Strides {
  int64_t b, s, h;
};

// Rotary tables of the ROT variant: (S, rot) f32, row = position; `vec`
// when K tiles can be rotated in 16-byte chunks (rot % 16 == 0, tables
// 16-byte aligned).
struct Rotary {
  const float* cos;
  const float* sin;
  int rot;
  bool vec;
};

// x * c + rh * s in f32, each product and the sum rounded on its own (the
// caller rounds the result to bf16)
__device__ __forceinline__ float rotary(float x, float c, float rh, float s) {
  return __fadd_rn(__fmul_rn(x, c), __fmul_rn(rh, s));
}

// two packed bf16 (the first in the low half) as floats
__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// rotate-half rotary of feature d < rot of the q row p at position pos, with
// rh = -x[d + rot/2] below rot/2 and x[d - rot/2] above
__device__ __forceinline__ float rotate_q(const __nv_bfloat16* p, int d, float x,
                                          const Rotary& rt, int pos) {
  const int half = rt.rot >> 1;
  const float partner = __bfloat162float(p[d < half ? d + half : d - half]);
  const int64_t t = (int64_t)pos * rt.rot + d;
  const float rh = d < half ? -partner : partner;
  const float r = rotary(x, __ldg(rt.cos + t), rh, __ldg(rt.sin + t));
  return __bfloat162float(__float2bfloat16(r));
}

// q row `row` (zero beyond Sq), features d, d + 1 (zero beyond D), rotated
// with ROT, times scale in f32, rounded to bf16 and packed
template <bool ROT>
__device__ __forceinline__ uint32_t q_pair(const __nv_bfloat16* qp, int row, int Sq,
                                           int d, int D, const Strides& qs, float scale,
                                           const Rotary& rt) {
  if (row >= Sq || d >= D) return 0u;
  const __nv_bfloat16* p = qp + (int64_t)row * qs.s;
  float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p + d));
  if (ROT && d < rt.rot) {  // d and rot are even, so d + 1 < rot as well
    f.x = rotate_q(p, d, f.x, rt, row);
    f.y = rotate_q(p, d + 1, f.y, rt, row);
  }
  return pack_bf16(f.x * scale, f.y * scale);
}

// Byte offset of feature d of key row `row` in a K tile: column block
// d / (W / 2), then the swizzle TMA wrote it with, which XORs the 16-byte
// chunk index (offset bits 4 and up) with offset bits 7 and up. Column
// blocks are 1024-byte aligned, so offset bits and address bits agree.
template <class C>
__device__ __forceinline__ uint32_t tile_offset(int row, int d) {
  const uint32_t o = row * C::W + (d % (C::W / 2)) * 2;
  const uint32_t swizzled = o ^ (((o >> 7) & (C::W / 16 - 1)) << 4);
  return (d / (C::W / 2)) * C::SUB + swizzled;
}

// Rotate the first `rows` keys of the K tile at kt (positions n0...) in
// place, one (d, d + rot/2) pair at a time: thread `tid` of ROTATORS takes
// whole pairs, so no pair is read by one thread and written by another.
template <class C>
__device__ __forceinline__ void rotate_k_tile(uint8_t* kt, int n0, int rows,
                                              const Rotary& rt, int tid) {
  const int half = rt.rot >> 1;
  for (int e = tid; e < rows * half; e += ROTATORS) {
    const int row = e / half;
    const int d = e - row * half;
    auto* lo = reinterpret_cast<__nv_bfloat16*>(kt + tile_offset<C>(row, d));
    auto* hi = reinterpret_cast<__nv_bfloat16*>(kt + tile_offset<C>(row, d + half));
    const float x0 = __bfloat162float(*lo);
    const float x1 = __bfloat162float(*hi);
    const int64_t t = (int64_t)(n0 + row) * rt.rot + d;
    *lo = __float2bfloat16(rotary(x0, __ldg(rt.cos + t), -x1, __ldg(rt.sin + t)));
    *hi = __float2bfloat16(
        rotary(x1, __ldg(rt.cos + t + half), x0, __ldg(rt.sin + t + half)));
  }
}

// 8 consecutive floats from 16-byte aligned global memory
__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  f[0] = a.x;
  f[1] = a.y;
  f[2] = a.z;
  f[3] = a.w;
  f[4] = b.x;
  f[5] = b.y;
  f[6] = b.z;
  f[7] = b.w;
}

// The same rotation a 16-byte chunk at a time (rot a multiple of 16, tables
// 16-byte aligned): thread `tid` takes the 8 features d0... of a key below
// rot/2 with their partner chunk d0 + rot/2. TMA's swizzle moves whole
// 16-byte chunks, so each chunk is one shared-memory access; this takes
// about a quarter of the per-pair loop's instructions, which the three
// rotating warps would otherwise spend longer on than the consumers spend
// on a tile.
template <class C>
__device__ __forceinline__ void rotate_k_tile_vec(uint8_t* kt, int n0, int rows,
                                                  const Rotary& rt, int tid) {
  const int half = rt.rot >> 1;
  const int chunks = half / 8;
  for (int e = tid; e < rows * chunks; e += ROTATORS) {
    const int row = e / chunks;
    const int d0 = (e - row * chunks) * 8;
    uint4* lo = reinterpret_cast<uint4*>(kt + tile_offset<C>(row, d0));
    uint4* hi = reinterpret_cast<uint4*>(kt + tile_offset<C>(row, d0 + half));
    const uint4 xl = *lo, xh = *hi;
    const int64_t t = (int64_t)(n0 + row) * rt.rot + d0;
    float c0[8], s0[8], c1[8], s1[8];
    load8(rt.cos + t, c0);
    load8(rt.sin + t, s0);
    load8(rt.cos + t + half, c1);
    load8(rt.sin + t + half, s1);
    const uint32_t* xl2 = reinterpret_cast<const uint32_t*>(&xl);
    const uint32_t* xh2 = reinterpret_cast<const uint32_t*>(&xh);
    uint4 ol, oh;
    uint32_t* ol2 = reinterpret_cast<uint32_t*>(&ol);
    uint32_t* oh2 = reinterpret_cast<uint32_t*>(&oh);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 a = unpack_bf16(xl2[i]);
      const float2 b = unpack_bf16(xh2[i]);
      const int j = 2 * i;
      ol2[i] = pack_bf16(rotary(a.x, c0[j], -b.x, s0[j]),
                         rotary(a.y, c0[j + 1], -b.y, s0[j + 1]));
      oh2[i] = pack_bf16(rotary(b.x, c1[j], a.x, s1[j]),
                         rotary(b.y, c1[j + 1], a.y, s1[j + 1]));
    }
    *lo = ol;
    *hi = oh;
  }
}

template <int DP, int DV, bool ROT>
__global__ void __launch_bounds__(Cfg<DP, DV>::THREADS, 1)
attn_tc_kernel(const __grid_constant__ CUtensorMap kmap,
               const __grid_constant__ CUtensorMap vmap,
               const __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ o,
               int H, int rep, int Sq, int kv_len, int D, float scale, Strides qs,
               Strides os, Rotary rt) {
  using C = Cfg<DP, DV>;
  constexpr int CONSUMERS = C::CONSUMERS;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ __align__(8) uint64_t empty[STAGES];
  __shared__ __align__(8) uint64_t rotated[STAGES];  // ROT: K tile rotated
  uint8_t* smem = align1024(smem_raw);

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int tiles = (kv_len + C::BN - 1) / C::BN;
  const int wg = threadIdx.x / 128;
  const int c0 = blockIdx.z * DV;  // this block's V and output columns

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * 128);
      if (ROT) mbar_init(&rotated[s], ROTATORS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // producer: one thread keeps the ring full; with ROT, warps 1-3 rotate
    // each K tile after it lands
    if (ROT && threadIdx.x >= CONSUMERS * 128 + 32) {
      const int tid = threadIdx.x - CONSUMERS * 128 - 32;
      for (int t = 0; t < tiles; ++t) {
        const int s = t % STAGES;
        mbar_wait(&full[s], (t / STAGES) & 1);
        const int n0 = t * C::BN;
        uint8_t* kt = smem + s * C::STAGE;
        const int rows = min(C::BN, kv_len - n0);
        if (rt.vec) {
          rotate_k_tile_vec<C>(kt, n0, rows, rt, tid);
        } else {
          rotate_k_tile<C>(kt, n0, rows, rt, tid);
        }
        fence_proxy_async();  // the consumers' wgmma reads the rotated tile
        mbar_arrive(&rotated[s]);
      }
    } else if (threadIdx.x == CONSUMERS * 128) {
      const int hk = h / rep;
      for (int t = 0; t < tiles; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES) mbar_wait(&empty[s], ((t / STAGES) - 1) & 1);
        uint8_t* kt = smem + s * C::STAGE;
        uint8_t* vt = kt + C::TILE;
        mbar_arrive_expect_tx(&full[s], C::STAGE);
#pragma unroll
        for (int a = 0; a < C::ATOMS; ++a) {
          tma_load_4d(kt + a * C::SUB, &kmap, &full[s], a * (C::W / 2), hk,
                      t * C::BN, b);
        }
#pragma unroll
        for (int a = 0; a < C::ATOMS_V; ++a) {
          tma_load_4d(vt + a * C::SUB, &vmap, &full[s], c0 + a * (C::W / 2), hk,
                      t * C::BN, b);
        }
      }
    }
  } else {
    // consumer warpgroup: rows r and r + 8 of each warp's 16, columns
    // 8 j + c2 and + 1 of every accumulator block j
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int r = blockIdx.y * C::BM + wg * 64 + (tid / 32) * 16 + lane / 4;
    const int c2 = (lane % 4) * 2;

    uint32_t qf[DP / 16][4];
    {
      const __nv_bfloat16* qp = q + b * qs.b + h * qs.h;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        qf[kk][0] = q_pair<ROT>(qp, r, Sq, 16 * kk + c2, D, qs, scale, rt);
        qf[kk][1] = q_pair<ROT>(qp, r + 8, Sq, 16 * kk + c2, D, qs, scale, rt);
        qf[kk][2] = q_pair<ROT>(qp, r, Sq, 16 * kk + 8 + c2, D, qs, scale, rt);
        qf[kk][3] = q_pair<ROT>(qp, r + 8, Sq, 16 * kk + 8 + c2, D, qs, scale, rt);
      }
    }

    float acc[DV / 2];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};

    for (int t = 0; t < tiles; ++t) {
      const int s = t % STAGES;
      mbar_wait(&full[s], (t / STAGES) & 1);
      if (ROT) mbar_wait(&rotated[s], (t / STAGES) & 1);
      const uint8_t* kt = smem + s * C::STAGE;
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
        for (int j = 0; j < DV / 8; ++j) {
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
        if constexpr (DV <= 128) {
          WgmmaRS<DV, 1>::run(acc, pf[kk],
                              smem_desc(vt + kk * 16 * C::W, C::LBO_V, 8 * C::W,
                                        wgmma_layout(C::W)),
                              1);
        } else {
          // column block a holds features 64 a ... 64 a + 63, which are
          // accumulators 32 a ... 32 a + 31 of the m64nDV layout
#pragma unroll
          for (int a = 0; a < C::ATOMS_V; ++a) {
            WgmmaRS<64, 1>::run(*reinterpret_cast<float(*)[32]>(acc + 32 * a), pf[kk],
                                smem_desc(vt + a * C::SUB + kk * 16 * C::W, C::LBO_V,
                                          8 * C::W, wgmma_layout(C::W)),
                                1);
          }
        }
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
    for (int j = 0; j < DV / 8; ++j) {
      const int d = c0 + 8 * j + c2;
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
template <class C>
int make_maps(CUtensorMap* kmap, CUtensorMap* vmap, const void* k, const void* v,
              int B, int H_kv, int kv_len, int D, const Strides& ks,
              const Strides& vs) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H_kv, (cuuint64_t)kv_len,
                              (cuuint64_t)B};
  const cuuint32_t box[4] = {(cuuint32_t)(C::W / 2), 1, (cuuint32_t)C::BN, 1};
  const cuuint64_t kst[3] = {(cuuint64_t)ks.h * 2, (cuuint64_t)ks.s * 2,
                             (cuuint64_t)ks.b * 2};
  const cuuint64_t vst[3] = {(cuuint64_t)vs.h * 2, (cuuint64_t)vs.s * 2,
                             (cuuint64_t)vs.b * 2};
  const CUtensorMapDataType bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  int rc = encode_map(kmap, bf16, 4, k, dims, kst, box, C::W);
  if (rc == 0) rc = encode_map(vmap, bf16, 4, v, dims, vst, box, C::W);
  return rc;
}

template <int DP, bool ROT, int DV = DP>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int H_kv, int Sq, int kv_len, int D, float scale, const Strides& qs,
           const Strides& ks, const Strides& vs, const Strides& os, const Rotary& rt,
           cudaStream_t stream) {
  using C = Cfg<DP, DV>;
  CUtensorMap kmap, vmap;
  const int rc = make_maps<C>(&kmap, &vmap, k, v, B, H_kv, kv_len, D, ks, vs);
  if (rc != 0) return rc < 0 ? rc : -rc;
  cudaError_t err = cudaFuncSetAttribute(
      attn_tc_kernel<DP, DV, ROT>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (Sq + C::BM - 1) / C::BM, DP / DV);
  attn_tc_kernel<DP, DV, ROT><<<grid, C::THREADS, C::SMEM, stream>>>(
      kmap, vmap, static_cast<const __nv_bfloat16*>(q),
      static_cast<__nv_bfloat16*>(o), H, H / H_kv, Sq, kv_len, D, scale, qs, os, rt);
  return static_cast<int>(cudaGetLastError());
}

template <bool ROT>
int run(const void* q, const void* k, const void* v, void* o, int B, int H, int H_kv,
        int Sq, int kv_len, int D, float scale, const Strides& qs, const Strides& ks,
        const Strides& vs, const Strides& os, const Rotary& rt, void* stream) {
  if (B < 1 || H < 1 || H_kv < 1 || H % H_kv != 0 || Sq < 1 || kv_len < 1 ||
      D < 8 || D % 8 != 0 || D > 256 || (Sq + 63) / 64 > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
  const int64_t strides =
      qs.b | qs.s | qs.h | ks.b | ks.s | ks.h | vs.b | vs.s | vs.h | os.b | os.s | os.h;
  if (bases % 16 != 0 || strides % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 16) {
    return launch<16, ROT>(q, k, v, o, B, H, H_kv, Sq, kv_len, D, scale, qs, ks, vs,
                           os, rt, st);
  }
  if (D <= 32) {
    return launch<32, ROT>(q, k, v, o, B, H, H_kv, Sq, kv_len, D, scale, qs, ks, vs,
                           os, rt, st);
  }
  if (D <= 64) {
    return launch<64, ROT>(q, k, v, o, B, H, H_kv, Sq, kv_len, D, scale, qs, ks, vs,
                           os, rt, st);
  }
  if (D <= 128) {
    return launch<128, ROT>(q, k, v, o, B, H, H_kv, Sq, kv_len, D, scale, qs, ks, vs,
                            os, rt, st);
  }
  if (D <= 192) {
    return launch<192, ROT>(q, k, v, o, B, H, H_kv, Sq, kv_len, D, scale, qs, ks, vs,
                            os, rt, st);
  }
  return launch<256, ROT, 128>(q, k, v, o, B, H, H_kv, Sq, kv_len, D, scale, qs, ks, vs,
                               os, rt, st);
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
  return run<false>(q, k, v, o, B, H, H_kv, Sq, kv_len, D, scale,
                    Strides{q_sb, q_ss, q_sh}, Strides{k_sb, k_ss, k_sh},
                    Strides{v_sb, v_ss, v_sh}, Strides{o_sb, o_ss, o_sh},
                    Rotary{nullptr, nullptr, 0, false}, stream);
}

// The rotary variant: as aec_flash_attention_tc_fwd, square (Sq equal to
// kv_len), with cos/sin (>= Sq, rot) contiguous f32 tables and rot even,
// 2 <= rot <= D.
extern "C" int aec_flash_attention_rotary_tc_fwd(
    const void* q, const void* k, const void* v, void* o, const void* cos,
    const void* sin, int rot, int B, int H, int H_kv, int Sq, int kv_len, int D,
    float scale, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh, void* stream) {
  if (rot < 2 || rot % 2 != 0 || rot > D || cos == nullptr || sin == nullptr ||
      Sq != kv_len) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uintptr_t tables =
      reinterpret_cast<uintptr_t>(cos) | reinterpret_cast<uintptr_t>(sin);
  return run<true>(q, k, v, o, B, H, H_kv, Sq, kv_len, D, scale,
                   Strides{q_sb, q_ss, q_sh}, Strides{k_sb, k_ss, k_sh},
                   Strides{v_sb, v_ss, v_sh}, Strides{o_sb, o_ss, o_sh},
                   Rotary{static_cast<const float*>(cos), static_cast<const float*>(sin),
                          rot, rot % 16 == 0 && tables % 16 == 0},
                   stream);
}
