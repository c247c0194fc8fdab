// Blocked non-causal self-attention for Hopper (sm_90a), float32, plain C
// interface.
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
// last dim must be contiguous), so no transpose copy is made. D a multiple
// of 8 up to 128.
//
// Rotary variant (ROT, the Stable Audio DiT's attn1 behind
// AEC_ROTARY_IN_KERNEL=1): a rotate-half rotary embedding is applied in f32
// to the first `rot` features of q and of k, from (S, rot) f32 cos/sin
// tables indexed by position, as _rotate does. Each thread rotates its q
// row in registers before the q*scale product; each K tile is rotated as it
// lands in shared memory (the partner feature d +- rot/2 is read from the
// same row, which the tile load has just brought into L1). The rotated q
// and k never reach device memory. Square self-attention only (the tables
// index queries and keys by the same position); rot even and <= D. The
// products and the sum of the rotation are rounded separately (no FMA
// contraction), as the plain PyTorch version computes them.
//
// Blocking. The TPU kernel keeps the whole K/V of one head in VMEM and does
// a one-pass softmax; a Hopper block has at most 227 KB of shared memory,
// so this kernel streams K/V tiles of BN keys through shared memory and
// keeps an online softmax (running max m, running sum l, f32 accumulator
// in registers). One thread owns one query row; a block of BM = 128 rows
// handles one (batch*head, query tile). Each k/v element is read from
// shared memory as a float4 broadcast, so a warp issues one shared load per
// four FMAs.
//
// What bounds it on an H100. At the main UNet shape (B*H = 16, S = 4096,
// D = 16) the function is 4*16*4096^2*16 = 17.2 GFLOP and 268 M
// exponentials on 8.4 MB of q/k/v/o in f32: it is bound by operations, not
// bytes. This kernel runs the products on the CUDA cores in f32, so its
// bound is the f32 FMA rate (67 TFLOP/s, 0.26 ms at that shape). The
// design keeps the FMA pipe fed: all loops over D and over the BN keys of a
// tile are unrolled at compile time (D and BN are template arguments),
// scores of a tile stay in registers, and the only shared-memory traffic is
// the broadcast float4 loads.
//
// Routes (ops/flash_attention.py::attention_route): float32 B1 and B2 run
// here; bfloat16 B1 and B2 run on the tensor cores in flash_attention_tc.cu
// (TMA, mbarriers, wgmma).
//
// Launch errors are returned as cudaGetLastError() to the caller.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;  // query rows (= threads) per block

// keys per shared-memory tile: the tile's scores live in registers beside
// the q row and the accumulator (D + D + BN floats per thread)
template <int D>
struct Tile {
  static constexpr int BN = D <= 32 ? 64 : (D <= 64 ? 32 : 16);
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

// rotate-half rotary of feature d < rot of one row p: x*cos + rh*sin with
// rh = -x[d + rot/2] for d < rot/2 and x[d - rot/2] above, in f32
__device__ __forceinline__ float rotate(const float* p, int d, float x,
                                        const Rotary& r, int pos) {
  const int half = r.rot >> 1;
  const float partner = __ldg(p + (d < half ? d + half : d - half));
  const float rh = d < half ? -partner : partner;
  const int64_t t = (int64_t)pos * r.rot + d;
  return __fadd_rn(__fmul_rn(x, __ldg(r.cos + t)), __fmul_rn(rh, __ldg(r.sin + t)));
}

template <int D, bool ROT>
__global__ void __launch_bounds__(BM)
attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ o, int H, int rep,
                int Sq, int kv_len, float scale, Strides qs, Strides ks,
                Strides vs, Strides os, Rotary rt) {
  constexpr int BN = Tile<D>::BN;
  __shared__ __align__(16) float k_tile[BN * D];
  __shared__ __align__(16) float v_tile[BN * D];

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / rep;
  const int row = blockIdx.y * BM + threadIdx.x;
  const bool active = row < Sq;

  const float* kp = k + b * ks.b + hk * ks.h;
  const float* vp = v + b * vs.b + hk * vs.h;

  float qr[D];
  float acc[D];
  {
    const float* qp = q + b * qs.b + (int64_t)(active ? row : 0) * qs.s + h * qs.h;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      float x = active ? __ldg(qp + d) : 0.f;
      if (ROT && active && d < rt.rot) x = rotate(qp, d, x, rt, row);
      qr[d] = x * scale;
      acc[d] = 0.f;
    }
  }
  float m = -INFINITY;
  float l = 0.f;

  for (int n0 = 0; n0 < kv_len; n0 += BN) {
    __syncthreads();  // every thread is done with the previous tile
    for (int e = threadIdx.x; e < BN * D; e += BM) {
      const int j = e / D;
      const int d = e - j * D;
      const int n = n0 + j;
      float kv = 0.f, vv = 0.f;
      if (n < kv_len) {
        const float* kr = kp + (int64_t)n * ks.s;
        kv = __ldg(kr + d);
        if (ROT && d < rt.rot) kv = rotate(kr, d, kv, rt, n);
        vv = __ldg(vp + (int64_t)n * vs.s + d);
      }
      k_tile[e] = kv;
      v_tile[e] = vv;
    }
    __syncthreads();

    float s[BN];
    float mt = -INFINITY;
#pragma unroll
    for (int j = 0; j < BN; ++j) {
      float a = 0.f;
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(&k_tile[j * D + d]);
        a = fmaf(qr[d], kk.x, a);
        a = fmaf(qr[d + 1], kk.y, a);
        a = fmaf(qr[d + 2], kk.z, a);
        a = fmaf(qr[d + 3], kk.w, a);
      }
      s[j] = (n0 + j < kv_len) ? a : -INFINITY;
      mt = fmaxf(mt, s[j]);
    }
    // the tile holds at least one real key, so mn is finite
    const float mn = fmaxf(m, mt);
    const float alpha = __expf(m - mn);  // 0 on the first tile
    l *= alpha;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < BN; ++j) {
      const float p = __expf(s[j] - mn);
      l += p;
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(&v_tile[j * D + d]);
        acc[d] = fmaf(p, vv.x, acc[d]);
        acc[d + 1] = fmaf(p, vv.y, acc[d + 1]);
        acc[d + 2] = fmaf(p, vv.z, acc[d + 2]);
        acc[d + 3] = fmaf(p, vv.w, acc[d + 3]);
      }
    }
    m = mn;
  }

  if (active) {
    float* op = o + b * os.b + (int64_t)row * os.s + h * os.h;
#pragma unroll
    for (int d = 0; d < D; ++d) op[d] = acc[d] / l;
  }
}

template <int D>
void launch(const void* q, const void* k, const void* v, void* o, int B, int H,
            int rep, int Sq, int kv_len, float scale, Strides qs, Strides ks,
            Strides vs, Strides os, Rotary rt, cudaStream_t stream) {
  const dim3 grid(B * H, (Sq + BM - 1) / BM);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  if (rt.rot > 0) {
    attn_fwd_kernel<D, true><<<grid, BM, 0, stream>>>(
        qf, kf, vf, of, H, rep, Sq, kv_len, scale, qs, ks, vs, os, rt);
  } else {
    attn_fwd_kernel<D, false><<<grid, BM, 0, stream>>>(
        qf, kf, vf, of, H, rep, Sq, kv_len, scale, qs, ks, vs, os, rt);
  }
}

int run(const void* q, const void* k, const void* v, void* o, int B, int H,
        int H_kv, int Sq, int kv_len, int D, float scale, const Strides& qs,
        const Strides& ks, const Strides& vs, const Strides& os, const Rotary& rt,
        void* stream) {
  if (B < 1 || H < 1 || H_kv < 1 || H % H_kv != 0 || Sq < 1 || kv_len < 1 ||
      (Sq + BM - 1) / BM > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rep = H / H_kv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define AEC_CASE(DD)                                                              \
  case DD:                                                                        \
    launch<DD>(q, k, v, o, B, H, rep, Sq, kv_len, scale, qs, ks, vs, os, rt, st); \
    break;
  switch (D) {
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
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef AEC_CASE
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// float32 (bfloat16 B1 is aec_flash_attention_tc_fwd). Strides are in
// elements; the last dim of every tensor must be contiguous. Returns
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
