// Blocked non-causal self-attention for Hopper (sm_90a), float32, with the
// products on the tensor cores in 3xTF32, plain C interface.
//
// Replaces audioeditingcode_tpu/ops/flash_attention.py::_attn_kernel (body
// _attn_core; host wrapper _blocked_attention) and, as its ROT variant,
// _attn_rotary_kernel (with _rotate), for float32 inputs. It computes the
// same function: o = softmax(q k^T / sqrt(D)) v for every (batch, head),
// with
//   - q * scale, scores, softmax and the output accumulator in f32,
//   - keys at index >= kv_len masked out of the softmax,
//   - grouped-query attention: q head h reads kv head h / (H / H_kv).
// Inputs are (B, S, H, D) tensors addressed through their strides (the
// last dim must be contiguous), so no transpose copy is made. Any head dim
// 1 <= D <= 256, in both variants: each instance has a width DK (the next
// multiple of 8 up to 128, then 160, 192 or 256), features D ... DK - 1 of q,
// K and V are zero-filled in shared memory and registers (they add 0 to
// q k^T and give output columns that are not stored), and the caller's
// scale is 1/sqrt(D) of the true D.
//
// Wide heads (DK = 192, 256) split V's output features across blocks: a
// grid axis over column blocks of DV = 96 or 128 features. Each block
// computes the whole S = q K^T over all DK features (q and K read in full)
// and the PV product for its own DV columns only, so its accumulators and
// V tile keep the sizes of a D = 96 or 128 instance; the price is one
// extra q K^T per extra column block. Each block runs the same sums in the
// same order, so the softmax statistics agree bit for bit across them.
//
// Products in 3xTF32. Both products, S = (q * scale) K^T and O += P V, run
// as warp-level mma.sync m16n8k8 TF32 tiles with f32 accumulators. Each
// operand x is split into TF32 parts hi (x at 11 significant bits) and lo
// (the rest, cut to TF32), so hi + lo is x to about 2^-22 |x|, and each
// product is accumulated as lo_a hi_b + hi_a lo_b + hi_a hi_b (the small
// terms first; lo_a lo_b, about 2^-22 of the product, is dropped). That
// keeps float32 accuracy (tests/test_torch_flash_attention.py: one TF32
// product would not). q is split after q * scale, p after the exponential,
// each K and V element as a warp reads it. The tensor cores truncate each
// sum they add into an accumulator, so a long chain of them drifts toward
// zero: PV is summed over one tile (24 products) in accumulators of its own
// and added to O with one rounded FMA. Chained over the whole sequence
// (1536 products at S = 4096) it drifts past F32_TOL.
//
// Blocking. The TPU kernel keeps the whole K/V of one head in VMEM and does
// a one-pass softmax; a Hopper block has at most 227 KB of shared memory,
// so this kernel streams K/V tiles of BN = 64 keys through shared memory
// (32 above D = 128: q's two split halves and two stages of 64-key tiles
// would take 244 KB at D = 160) and keeps an online softmax. A block of 4 warps takes BM = 64 query rows
// of one (batch, head); each warp owns 16 rows, and each thread rows g and
// g + 8 of them (g = lane / 4) at the columns 2t, 2t + 1 of every 8-wide
// accumulator tile (t = lane % 4). The four lanes of a row reduce its max
// and sum with shuffles. Four warps rather than eight: more blocks (the
// UNet's (2, 1024, 8, 32) gives 256 on 132 SMs), and shared memory still
// leaves room for two or more blocks an SM up to D = 72 (one above). The
// launch bound asks for one block an SM, so that ptxas may take up to 255
// registers: left to itself it capped some instances at 128 or 168 and
// spilled, which was slower.
//   - K/V tiles arrive by 16-byte cp.async.cg copies, double-buffered: tile
//     n + 1 is in flight while tile n is multiplied. Rows past kv_len are
//     zero-filled. K/V with a base or a stride that is not a multiple of 4
//     floats take 4-byte copies instead (same kernel, a runtime branch).
//   - Each shared K/V row is padded by 4 floats, so the 8 rows a fragment
//     load touches (rows g, or rows 2t and 2t + 1 of V) fall on 32 banks.
//   - q's TF32 hi and lo fragments are made once per block and kept in
//     shared memory in fragment order (each thread reads back one float4 of
//     each a step): in registers they would take D floats a thread.
//   - P feeds the PV product without shuffles: the S accumulator holds keys
//     2t and 2t + 1 of each 8, the TF32 A fragment wants columns t and
//     t + 4, and since the keys of a tile are summed over, A column t is
//     taken as key 2t and column t + 4 as key 2t + 1, and V's B fragment is
//     read from rows 2t and 2t + 1 to match.
// Query rows >= Sq read zeros and are not stored. No atomics and a fixed
// order of every sum: the result is deterministic.
//
// Rotary variant (ROT, the Stable Audio DiT's attn1 behind
// AEC_ROTARY_IN_KERNEL=1): a rotate-half rotary embedding is applied in f32
// to the first `rot` features of q and of k, from (S, rot) f32 cos/sin
// tables indexed by position, as _rotate does, with the products and the
// sum rounded separately (no FMA contraction), as the plain PyTorch version
// computes them. q is rotated as it is read, before the scale and the
// split. Each K tile is rotated in place in shared memory once its copy has
// landed, between two barriers, one (key, d < rot/2) pair a thread at a
// time, with the table loads of eight pairs (four above D = 96) in flight
// together (the whole block waits on their latency); rows past kv_len are
// skipped, the tables end there.
// The same f32 q and k then reach the same products in the same order as
// the host rotary followed by B1, so B2 is bit-equal to that. The rotated q
// and k never reach device memory. Square self-attention only; rot even and
// <= D.
//
// What bounds it on an H100. At the DiT's (2, 1025, 24/12, 64) the function
// is 12.9 GFLOP of products, 38.7 GFLOP as three TF32 products: 0.078 ms at
// the 495 TFLOP/s TF32 peak, against 0.193 ms for one f32 FMA product at 67
// TFLOP/s. At the UNet's (2, 4096, 8, 16) the three products take 0.104 ms
// and the 268 M exponentials 0.064 ms on the SFU, so at D = 16 the
// exponentials are a large share: a tile's softmax runs 32 exponentials a
// thread against 96 mma. mma.sync reaches only part of the wgmma peak, and
// each split costs five ALU operations per K/V element a warp reads; the
// design keeps every warp's tiles in registers, loads K/V once per block
// and overlaps the next tile's copy with this tile's products.
//
// Routes (ops/flash_attention.py::attention_route): float32 B1 and B2 run
// here; bfloat16 B1 and B2 run in flash_attention_tc.cu (TMA, mbarriers,
// wgmma).
//
// Launch errors are returned as cudaGetLastError() to the caller.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32.cuh"

namespace {

using aec_tc::split;

constexpr int WARPS = 4;          // each owns 16 query rows
constexpr int BM = 16 * WARPS;    // query rows per block
constexpr int THREADS = 32 * WARPS;

// DK: the width of q and K (features >= D zero-filled); DV: the V and
// output columns of one block (DV = DK, or DK split in column blocks)
template <int DK, int DV>
struct Cfg {
  static constexpr int BN = DK > 128 ? 32 : 64;  // keys per K/V tile
  static constexpr int LDK = DK + 4;       // floats of a shared K row (padded)
  static constexpr int LDV = DV + 4;       // floats of a shared V row (padded)
  static constexpr int KC = DK / 8;        // k8 steps over the features
  static constexpr int VC = DV / 8;        // 8-wide output column blocks
  static constexpr int Q = BM * DK;        // floats of one split half of q
  static constexpr int TILE_K = BN * LDK;  // floats of a K tile
  static constexpr int TILE_V = BN * LDV;  // floats of a V tile
  static constexpr int STAGE = TILE_K + TILE_V;
  // q hi and lo, then two stages of (K, V)
  static constexpr int SMEM = (2 * Q + 2 * STAGE) * 4;
  static_assert(DK % DV == 0 && DV % 8 == 0, "column blocks of whole 8-wide tiles");
  static_assert(SMEM <= 232448, "a block takes at most 227 KB of shared memory");
};

struct Strides {
  int64_t b, s, h;
};

// Rotary tables of the ROT variant: (S, rot) f32, row = position.
struct Rotary {
  const float* cos;
  const float* sin;
  int rot;
};

// x * c + rh * s in f32, each product and the sum rounded on its own
__device__ __forceinline__ float rotary(float x, float c, float rh, float s) {
  return __fadd_rn(__fmul_rn(x, c), __fmul_rn(rh, s));
}

// rotate-half rotary of feature d < rot of one row p in global memory at
// position pos: rh = -x[d + rot/2] for d < rot/2 and x[d - rot/2] above
__device__ __forceinline__ float rotate(const float* p, int d, float x, const Rotary& r,
                                        int pos) {
  const int half = r.rot >> 1;
  const float partner = __ldg(p + (d < half ? d + half : d - half));
  const int64_t t = (int64_t)pos * r.rot + d;
  return rotary(x, __ldg(r.cos + t), d < half ? -partner : partner, __ldg(r.sin + t));
}

// d += a b for one m16n8k8 tile: a row-major 16 x 8, b column-major 8 x 8
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in 3xTF32, from the split halves of a and of b (elements 0, 1)
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh[0], bh[1]);
  mma_tf32(d, ah, bl[0], bl[1]);
  mma_tf32(d, ah, bh[0], bh[1]);
}

// Copy `bytes` (16 or 4) from global to shared memory asynchronously; with
// `src_bytes` 0 nothing is read and the destination is zero-filled.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most N of this thread's copy groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Start the copy of keys n0 ... n0 + BN - 1 of one head (rows `stride`
// floats apart), W features from src on, into a shared tile of rows LD
// floats apart; rows at or past kv_len and features at or past `cols`
// (what is left of the true D from src on) are zero-filled. 16-byte copies
// where `vec` (base, strides and D multiples of 4 floats), 4-byte copies
// otherwise.
template <int W, int LD, int BN>
__device__ __forceinline__ void load_tile(float* tile, const float* src, int64_t stride,
                                          int n0, int kv_len, int cols, bool vec) {
  if (vec) {
    constexpr int CHUNKS = W / 4;
#pragma unroll
    for (int i = 0; i < (BN * CHUNKS + THREADS - 1) / THREADS; ++i) {
      const int e = i * THREADS + threadIdx.x;
      if (BN * CHUNKS % THREADS != 0 && e >= BN * CHUNKS) break;
      const int j = e / CHUNKS;
      const int c = (e - j * CHUNKS) * 4;
      const bool in = n0 + j < kv_len && c < cols;
      cp_async16(tile + j * LD + c, in ? src + (int64_t)(n0 + j) * stride + c : src,
                 in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < BN * W; e += THREADS) {
      const int j = e / W;
      const int c = e - j * W;
      const bool in = n0 + j < kv_len && c < cols;
      cp_async4(tile + j * LD + c, in ? src + (int64_t)(n0 + j) * stride + c : src,
                in ? 4 : 0);
    }
  }
}

// Rotate the first `rows` keys of the shared K tile kt (positions n0 ...)
// in place. Pair e, feature e % (rot/2) of key e / (rot/2) with its partner
// at + rot/2, goes to thread e % THREADS, so a warp reads the tables in
// runs. Each thread loads the tables of up to BATCH of its pairs before it
// rotates any, so their latencies overlap (the block waits for this pass);
// four above D = 96, where eight pairs' tables beside the 64 accumulators
// of O would spill.
template <class C>
__device__ __forceinline__ void rotate_k_tile(float* kt, int n0, int rows, const Rotary& rt) {
  constexpr int BATCH = C::KC * 8 > 96 ? 4 : 8;
  const int half = rt.rot >> 1;
  const int total = rows * half;
  const int jstep = THREADS / half;
  const int dstep = THREADS - jstep * half;
  int j = threadIdx.x / half;
  int d = threadIdx.x - j * half;
  for (int e0 = threadIdx.x; e0 < total; e0 += BATCH * THREADS) {
    float c0[BATCH], s0[BATCH], c1[BATCH], s1[BATCH];
    int at[BATCH];
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      at[i] = j * C::LDK + d;
      if (e0 + i * THREADS < total) {
        const int64_t p = (int64_t)(n0 + j) * rt.rot + d;
        c0[i] = __ldg(rt.cos + p);
        s0[i] = __ldg(rt.sin + p);
        c1[i] = __ldg(rt.cos + p + half);
        s1[i] = __ldg(rt.sin + p + half);
      }
      j += jstep;
      d += dstep;
      if (d >= half) {
        d -= half;
        ++j;
      }
    }
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      if (e0 + i * THREADS < total) {
        float* x = kt + at[i];
        const float x0 = x[0];
        const float x1 = x[half];
        x[0] = rotary(x0, c0[i], -x1, s0[i]);
        x[half] = rotary(x1, c1[i], x0, s1[i]);
      }
    }
  }
}

template <int DK, int DV, bool ROT>
__global__ void __launch_bounds__(THREADS, 1)
attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ o, int H, int rep,
                int Sq, int kv_len, int D, float scale, Strides qs, Strides ks,
                Strides vs, Strides os, Rotary rt, bool vec) {
  using C = Cfg<DK, DV>;
  constexpr int BN = C::BN;
  extern __shared__ float4 smem[];
  float4* q_hi = smem;              // [WARPS][KC][32 lanes]
  float4* q_lo = smem + C::Q / 4;
  float* kv = reinterpret_cast<float*>(smem + C::Q / 2);  // stage s: K, then V

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / rep;
  const int r0 = blockIdx.x * BM + warp * 16 + g;  // this thread's rows r0, r0 + 8
  const int c0 = blockIdx.z * DV;                   // this block's output columns
  const int tiles = (kv_len + BN - 1) / BN;

  const float* kp = k + b * ks.b + hk * ks.h;
  const float* vp = v + b * vs.b + hk * vs.h + c0;

  // the first tile's copy runs while q is read and split
  load_tile<DK, C::LDK, BN>(kv, kp, ks.s, 0, kv_len, D, vec);
  load_tile<DV, C::LDV, BN>(kv + C::TILE_K, vp, vs.s, 0, kv_len, D - c0, vec);
  cp_async_commit();

  // q * scale (rotated first with ROT) as TF32 A fragments: step kc holds
  // a0 (row r0, feature 8 kc + t), a1 (r0 + 8, same), a2 (r0, 8 kc + t + 4)
  // and a3 (r0 + 8, 8 kc + t + 4). Each thread reads back only its own.
  {
    const float* qp = q + b * qs.b + h * qs.h;
#pragma unroll
    for (int kc = 0; kc < C::KC; ++kc) {
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + (i & 1) * 8;
        const int d = 8 * kc + t + (i >> 1) * 4;
        float x = 0.f;
        if (row < Sq && d < D) {
          const float* p = qp + (int64_t)row * qs.s;
          x = __ldg(p + d);
          if (ROT && d < rt.rot) x = rotate(p, d, x, rt, row);
        }
        split(__fmul_rn(x, scale), hi[i], lo[i]);  // rounded before the split
      }
      const int f = (warp * C::KC + kc) * 32 + lane;
      q_hi[f] = make_float4(__uint_as_float(hi[0]), __uint_as_float(hi[1]),
                            __uint_as_float(hi[2]), __uint_as_float(hi[3]));
      q_lo[f] = make_float4(__uint_as_float(lo[0]), __uint_as_float(lo[1]),
                            __uint_as_float(lo[2]), __uint_as_float(lo[3]));
    }
  }

  // O of rows r0 (elements 0, 1) and r0 + 8 (2, 3), columns c0 + 8 nf + 2t, + 1
  float acc[C::VC][4];
#pragma unroll
  for (int nf = 0; nf < C::VC; ++nf) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[nf][c] = 0.f;
  }
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  for (int tile = 0; tile < tiles; ++tile) {
    float* kt = kv + (tile & 1) * C::STAGE;
    float* vt = kt + C::TILE_K;
    if (tile + 1 < tiles) {  // the other stage was released at the end of the last tile
      float* next = kv + ((tile + 1) & 1) * C::STAGE;
      load_tile<DK, C::LDK, BN>(next, kp, ks.s, (tile + 1) * BN, kv_len, D, vec);
      load_tile<DV, C::LDV, BN>(next + C::TILE_K, vp, vs.s, (tile + 1) * BN, kv_len, D - c0,
                                vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile has landed for every thread
    const int n0 = tile * BN;
    if (ROT) {
      rotate_k_tile<C>(kt, n0, min(BN, kv_len - n0), rt);
      __syncthreads();
    }

    // S = (q * scale) K^T: block j holds keys n0 + 8 j + 2t, + 1 of rows r0
    // (elements 0, 1) and r0 + 8 (2, 3)
    float sc[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[j][c] = 0.f;
    }
#pragma unroll
    for (int kc = 0; kc < C::KC; ++kc) {
      const int f = (warp * C::KC + kc) * 32 + lane;
      const float4 fh = q_hi[f];
      const float4 fl = q_lo[f];
      const uint32_t ah[4] = {__float_as_uint(fh.x), __float_as_uint(fh.y),
                              __float_as_uint(fh.z), __float_as_uint(fh.w)};
      const uint32_t al[4] = {__float_as_uint(fl.x), __float_as_uint(fl.y),
                              __float_as_uint(fl.z), __float_as_uint(fl.w)};
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        // B (feature, key): b0 = K[key 8 j + g][8 kc + t], b1 at feature + 4
        const float* kr = kt + (8 * j + g) * C::LDK + 8 * kc + t;
        uint32_t bh[2], bl[2];
        split(kr[0], bh[0], bl[0]);
        split(kr[4], bh[1], bl[1]);
        mma_3xtf32(sc[j], ah, al, bh, bl);
      }
    }
    if (n0 + BN > kv_len) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (n0 + 8 * j + 2 * t + (c & 1) >= kv_len) sc[j][c] = -INFINITY;
        }
      }
    }

    // online softmax of rows r0 (x = 0) and r0 + 8 (x = 1); the tile holds
    // at least one real key, so mn is finite and alpha is 0 on the first
    float mn[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      mn[0] = fmaxf(mn[0], fmaxf(sc[j][0], sc[j][1]));
      mn[1] = fmaxf(mn[1], fmaxf(sc[j][2], sc[j][3]));
    }
    float alpha[2];
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      mn[x] = fmaxf(mn[x], __shfl_xor_sync(0xffffffffu, mn[x], 1));
      mn[x] = fmaxf(mn[x], __shfl_xor_sync(0xffffffffu, mn[x], 2));
      alpha[x] = __expf(m[x] - mn[x]);
      l[x] *= alpha[x];
      m[x] = mn[x];
    }

    // O = alpha O + P V, the tile's P V summed in accumulators of its own, 8
    // keys a step. P's A fragment comes straight from the S block: a0 =
    // p(r0, key 2t), a1 = p(r0 + 8, 2t), a2 = p(r0, 2t + 1), a3 = p(r0 + 8,
    // 2t + 1), so V's B fragment is read from key rows 2t and 2t + 1.
    float pv[C::VC][4];
#pragma unroll
    for (int nf = 0; nf < C::VC; ++nf) {
#pragma unroll
      for (int c = 0; c < 4; ++c) pv[nf][c] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      float p[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) p[c] = __expf(sc[j][c] - m[c >> 1]);
      l[0] += p[0] + p[1];
      l[1] += p[2] + p[3];
      uint32_t ah[4], al[4];
      split(p[0], ah[0], al[0]);
      split(p[2], ah[1], al[1]);
      split(p[1], ah[2], al[2]);
      split(p[3], ah[3], al[3]);
      const float* vr = vt + (8 * j + 2 * t) * C::LDV + g;
#pragma unroll
      for (int nf = 0; nf < C::VC; ++nf) {
        // B (key, feature): b0 = V[8 j + 2t][8 nf + g], b1 = V[8 j + 2t + 1][...]
        uint32_t bh[2], bl[2];
        split(vr[8 * nf], bh[0], bl[0]);
        split(vr[C::LDV + 8 * nf], bh[1], bl[1]);
        mma_3xtf32(pv[nf], ah, al, bh, bl);
      }
    }
#pragma unroll
    for (int nf = 0; nf < C::VC; ++nf) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[nf][c] = fmaf(acc[nf][c], alpha[c >> 1], pv[nf][c]);
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

#pragma unroll
  for (int x = 0; x < 2; ++x) {
    l[x] += __shfl_xor_sync(0xffffffffu, l[x], 1);
    l[x] += __shfl_xor_sync(0xffffffffu, l[x], 2);
  }
  float* op = o + b * os.b + h * os.h;
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int row = r0 + 8 * x;
    if (row >= Sq) continue;
    float* orow = op + (int64_t)row * os.s;
#pragma unroll
    for (int nf = 0; nf < C::VC; ++nf) {
      const int col = c0 + 8 * nf + 2 * t;
      if (col < D) orow[col] = acc[nf][2 * x] / l[x];
      if (col + 1 < D) orow[col + 1] = acc[nf][2 * x + 1] / l[x];
    }
  }
}

template <int DK, int DV, bool ROT>
int launch_variant(const float* q, const float* k, const float* v, float* o, int B, int H,
                   int rep, int Sq, int kv_len, int D, float scale, const Strides& qs,
                   const Strides& ks, const Strides& vs, const Strides& os, const Rotary& rt,
                   bool vec, cudaStream_t stream) {
  constexpr int SMEM = Cfg<DK, DV>::SMEM;
  const dim3 grid((Sq + BM - 1) / BM, B * H, DK / DV);
  const cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_kernel<DK, DV, ROT>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_fwd_kernel<DK, DV, ROT><<<grid, THREADS, SMEM, stream>>>(
      q, k, v, o, H, rep, Sq, kv_len, D, scale, qs, ks, vs, os, rt, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int DK, int DV = DK>
int launch(const float* q, const float* k, const float* v, float* o, int B, int H, int rep,
           int Sq, int kv_len, int D, float scale, const Strides& qs, const Strides& ks,
           const Strides& vs, const Strides& os, const Rotary& rt, bool vec,
           cudaStream_t stream) {
  if (rt.rot > 0) {
    return launch_variant<DK, DV, true>(q, k, v, o, B, H, rep, Sq, kv_len, D, scale, qs, ks,
                                        vs, os, rt, vec, stream);
  }
  return launch_variant<DK, DV, false>(q, k, v, o, B, H, rep, Sq, kv_len, D, scale, qs, ks,
                                       vs, os, rt, vec, stream);
}

int run(const void* q, const void* k, const void* v, void* o, int B, int H, int H_kv,
        int Sq, int kv_len, int D, float scale, const Strides& qs, const Strides& ks,
        const Strides& vs, const Strides& os, const Rotary& rt, void* stream) {
  if (B < 1 || H < 1 || H_kv < 1 || H % H_kv != 0 || Sq < 1 || kv_len < 1 || D < 1 ||
      D > 256 || (int64_t)B * H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rep = H / H_kv;
  // K and V take 16-byte copies when every row they copy from is 16-byte
  // aligned and a 4-float chunk lies wholly inside or outside D
  const uintptr_t bases = reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v);
  const int64_t strides = ks.b | ks.s | ks.h | vs.b | vs.s | vs.h;
  const bool vec = bases % 16 == 0 && strides % 4 == 0 && D % 4 == 0;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define AEC_CASE(DD) \
  case DD:           \
    return launch<DD>(qf, kf, vf, of, B, H, rep, Sq, kv_len, D, scale, qs, ks, vs, os, rt, vec, st);
  // the instance of the next multiple of 8 up to 128, then 160, 192, 256
  if (D > 192) {
    return launch<256, 128>(qf, kf, vf, of, B, H, rep, Sq, kv_len, D, scale, qs, ks, vs, os,
                            rt, vec, st);
  }
  if (D > 160) {
    return launch<192, 96>(qf, kf, vf, of, B, H, rep, Sq, kv_len, D, scale, qs, ks, vs, os,
                           rt, vec, st);
  }
  switch (D > 128 ? 160 : (D + 7) / 8 * 8) {
    AEC_CASE(8)
    AEC_CASE(16)
    AEC_CASE(24)
    AEC_CASE(32)
    AEC_CASE(40)
    AEC_CASE(48)
    AEC_CASE(56)
    AEC_CASE(64)
    AEC_CASE(72)
    AEC_CASE(80)
    AEC_CASE(88)
    AEC_CASE(96)
    AEC_CASE(104)
    AEC_CASE(112)
    AEC_CASE(120)
    AEC_CASE(128)
    AEC_CASE(160)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef AEC_CASE
}

}  // namespace

// float32 (bfloat16 B1 is aec_flash_attention_tc_fwd), 1 <= D <= 256.
// Strides are in elements; the last dim of every tensor must be contiguous. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for arguments
// the kernel does not take).
extern "C" int aec_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int H_kv, int Sq, int kv_len, int D, float scale, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh, void* stream) {
  return run(q, k, v, o, B, H, H_kv, Sq, kv_len, D, scale,
             Strides{q_sb, q_ss, q_sh}, Strides{k_sb, k_ss, k_sh},
             Strides{v_sb, v_ss, v_sh}, Strides{o_sb, o_ss, o_sh},
             Rotary{nullptr, nullptr, 0}, stream);
}

// The rotary variant in float32 (bfloat16 B2 is
// aec_flash_attention_rotary_tc_fwd): as aec_flash_attention_fwd, square (Sq
// equal to kv_len), with cos/sin (>= Sq, rot) contiguous f32 tables and rot
// even, 2 <= rot <= D.
extern "C" int aec_flash_attention_rotary_fwd(
    const void* q, const void* k, const void* v, void* o, const void* cos,
    const void* sin, int rot, int B, int H, int H_kv, int Sq, int kv_len, int D,
    float scale, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh, void* stream) {
  if (rot < 2 || rot % 2 != 0 || rot > D || cos == nullptr || sin == nullptr ||
      Sq != kv_len) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return run(q, k, v, o, B, H, H_kv, Sq, kv_len, D, scale,
             Strides{q_sb, q_ss, q_sh}, Strides{k_sb, k_ss, k_sh},
             Strides{v_sb, v_ss, v_sh}, Strides{o_sb, o_ss, o_sh},
             Rotary{static_cast<const float*>(cos), static_cast<const float*>(sin), rot},
             stream);
}
