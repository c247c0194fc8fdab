// Blocked non-causal self-attention for Hopper (sm_90a), plain C interface.
//
// Replaces audioeditingcode_tpu/ops/flash_attention.py::_attn_kernel (body
// _attn_core; host wrapper _blocked_attention) and, as its ROT variant,
// _attn_rotary_kernel (with _rotate). It computes the same function:
// o = softmax(q k^T / sqrt(D)) v for every (batch, head), with
//   - q * scale computed in f32 and rounded back to the input dtype,
//   - scores, softmax and the output accumulator in f32,
//   - p rounded to v's dtype before the PV product,
//   - keys at index >= kv_len masked out of the softmax,
//   - grouped-query attention: q head h reads kv head h / (H / H_kv).
// Inputs are (B, S, H, D) tensors addressed through their strides (the
// last dim must be contiguous), so no transpose copy is made. f32 and bf16,
// D a multiple of 8 up to 128.
//
// Rotary variant (ROT, the Stable Audio DiT's attn1 behind
// AEC_ROTARY_IN_KERNEL=1): a rotate-half rotary embedding is applied in f32
// to the first `rot` features of q and of k, from (S, rot) f32 cos/sin
// tables indexed by position, and the result is rounded to the input dtype
// before anything else touches it, as _rotate does. Each thread rotates its
// q row in registers before the q*scale rounding; each K tile is rotated as
// it lands in shared memory (the partner feature d +- rot/2 is read from
// the same row, which the tile load has just brought into L1). The rotated
// q and k never reach device memory. Square self-attention only (the tables
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
// Routes (ops/flash_attention.py::attention_route): float32 B1 and the
// rotary variant in both dtypes run here; bfloat16 B1 runs on the tensor
// cores in flash_attention_tc.cu (TMA, mbarriers, wgmma), so the bf16
// instances here are the rotary ones only, widening bf16 exactly to f32.
//
// Launch errors are returned as cudaGetLastError() to the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BM = 128;  // query rows (= threads) per block

template <typename T>
struct Io;

template <>
struct Io<float> {
  static __device__ __forceinline__ float load(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ void store(float* p, float x) { *p = x; }
};

template <>
struct Io<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(__ldg(p));
  }
  // round-to-nearest-even, as XLA's astype(bfloat16)
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16(x);
  }
};

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
// rh = -x[d + rot/2] for d < rot/2 and x[d - rot/2] above, in f32, rounded
// to T
template <typename T>
__device__ __forceinline__ float rotate(const T* p, int d, float x,
                                        const Rotary& r, int pos) {
  const int half = r.rot >> 1;
  const float partner = Io<T>::load(p + (d < half ? d + half : d - half));
  const float rh = d < half ? -partner : partner;
  const int64_t t = (int64_t)pos * r.rot + d;
  return Io<T>::round(__fadd_rn(__fmul_rn(x, __ldg(r.cos + t)),
                                __fmul_rn(rh, __ldg(r.sin + t))));
}

template <typename T, int D, bool ROT>
__global__ void __launch_bounds__(BM)
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, T* __restrict__ o, int H, int rep,
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

  const T* kp = k + b * ks.b + hk * ks.h;
  const T* vp = v + b * vs.b + hk * vs.h;

  float qr[D];
  float acc[D];
  {
    const T* qp = q + b * qs.b + (int64_t)(active ? row : 0) * qs.s + h * qs.h;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      float x = active ? Io<T>::load(qp + d) : 0.f;
      if (ROT && active && d < rt.rot) x = rotate(qp, d, x, rt, row);
      qr[d] = active ? Io<T>::round(x * scale) : 0.f;
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
        const T* kr = kp + (int64_t)n * ks.s;
        kv = Io<T>::load(kr + d);
        if (ROT && d < rt.rot) kv = rotate(kr, d, kv, rt, n);
        vv = Io<T>::load(vp + (int64_t)n * vs.s + d);
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
      const float pr = Io<T>::round(p);
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(&v_tile[j * D + d]);
        acc[d] = fmaf(pr, vv.x, acc[d]);
        acc[d + 1] = fmaf(pr, vv.y, acc[d + 1]);
        acc[d + 2] = fmaf(pr, vv.z, acc[d + 2]);
        acc[d + 3] = fmaf(pr, vv.w, acc[d + 3]);
      }
    }
    m = mn;
  }

  if (active) {
    T* op = o + b * os.b + (int64_t)row * os.s + h * os.h;
#pragma unroll
    for (int d = 0; d < D; ++d) Io<T>::store(op + d, acc[d] / l);
  }
}

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, void* o, int B, int H,
            int rep, int Sq, int kv_len, float scale, Strides qs, Strides ks,
            Strides vs, Strides os, Rotary rt, cudaStream_t stream) {
  const dim3 grid(B * H, (Sq + BM - 1) / BM);
  if (rt.rot > 0) {
    attn_fwd_kernel<T, D, true><<<grid, BM, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), H, rep, Sq, kv_len,
        scale, qs, ks, vs, os, rt);
  } else if constexpr (std::is_same<T, float>::value) {
    attn_fwd_kernel<T, D, false><<<grid, BM, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), H, rep, Sq, kv_len,
        scale, qs, ks, vs, os, rt);
  }
}

template <typename T>
bool dispatch(int D, const void* q, const void* k, const void* v, void* o,
              int B, int H, int rep, int Sq, int kv_len, float scale,
              Strides qs, Strides ks, Strides vs, Strides os, Rotary rt,
              cudaStream_t stream) {
#define AEC_CASE(DD)                                                         \
  case DD:                                                                   \
    launch<T, DD>(q, k, v, o, B, H, rep, Sq, kv_len, scale, qs, ks, vs, os, \
                  rt, stream);                                               \
    return true;
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
      return false;
  }
#undef AEC_CASE
}

int run(const void* q, const void* k, const void* v, void* o, int dtype,
        int B, int H, int H_kv, int Sq, int kv_len, int D, float scale,
        const Strides& qs, const Strides& ks, const Strides& vs,
        const Strides& os, const Rotary& rt, void* stream) {
  // bfloat16 is compiled for the rotary variant only (plain bf16 B1 is
  // flash_attention_tc.cu), so launch<bf16, D> without a rotary launches nothing
  if (B < 1 || H < 1 || H_kv < 1 || H % H_kv != 0 || Sq < 1 || kv_len < 1 ||
      (Sq + BM - 1) / BM > 65535 || (dtype == 1 && rt.rot == 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rep = H / H_kv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bool ok;
  if (dtype == 0) {
    ok = dispatch<float>(D, q, k, v, o, B, H, rep, Sq, kv_len, scale, qs, ks,
                         vs, os, rt, st);
  } else if (dtype == 1) {
    ok = dispatch<__nv_bfloat16>(D, q, k, v, o, B, H, rep, Sq, kv_len, scale,
                                 qs, ks, vs, os, rt, st);
  } else {
    ok = false;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
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
  return run(q, k, v, o, 0, B, H, H_kv, Sq, kv_len, D, scale,
             Strides{q_sb, q_ss, q_sh}, Strides{k_sb, k_ss, k_sh},
             Strides{v_sb, v_ss, v_sh}, Strides{o_sb, o_ss, o_sh},
             Rotary{nullptr, nullptr, 0}, stream);
}

// The rotary variant, in float32 (dtype 0) or bfloat16 (dtype 1): as
// aec_flash_attention_fwd, square (Sq equal to the keys' length), with
// cos/sin (>= Sq, rot) contiguous f32 tables and rot even, 2 <= rot <= D.
extern "C" int aec_flash_attention_rotary_fwd(
    const void* q, const void* k, const void* v, void* o, const void* cos,
    const void* sin, int rot, int dtype, int B, int H, int H_kv, int Sq,
    int kv_len, int D, float scale, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, void* stream) {
  if (rot < 2 || rot % 2 != 0 || rot > D || cos == nullptr || sin == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return run(q, k, v, o, dtype, B, H, H_kv, Sq, kv_len, D, scale,
             Strides{q_sb, q_ss, q_sh}, Strides{k_sb, k_ss, k_sh},
             Strides{v_sb, v_ss, v_sh}, Strides{o_sb, o_ss, o_sh},
             Rotary{static_cast<const float*>(cos),
                    static_cast<const float*>(sin), rot},
             stream);
}
