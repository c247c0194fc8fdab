"""The port's attention: the kernel's plain version against the Pallas
kernel (interpret mode) and XLA attention, and the dispatcher's routing.

Tolerances: 2e-5 in float32 (as tests/test_flash_attention.py: the sums run
in another order), 3e-2 in bfloat16 (one bf16 rounding of q and of p) and,
where a test holds the bound the card holds the bf16 kernels to,
``fa.BF16_TOL`` (two bf16 ulps, 4e-3 near zero)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audioeditingcode_tpu.ops.flash_attention import _blocked_attention, _host_rotary
from audioeditingcode_tpu.models.dit1d import rotary_tables as j_rotary_tables
from audioeditingcode_tpu_torch.ops import flash_attention as fa
from test_torch_helpers import tf32_round, tf32_split, to_np

# (B, S, H, H_kv, D, dtype): the tests/test_flash_attention.py shapes, the
# ragged DiT sequence, GQA and TANGO's head dim
CASES = [
    (2, 512, 2, 2, 64, "float32"),
    (2, 768, 3, 3, 32, "float32"),
    (2, 1024, 1, 1, 16, "float32"),
    (1, 1024, 2, 2, 40, "float32"),
    (2, 1025, 3, 3, 64, "float32"),
    (2, 1025, 4, 2, 64, "float32"),
    (1, 512, 2, 2, 64, "bfloat16"),
    (1, 1025, 4, 2, 40, "bfloat16"),
]


def _qkv(B, S, H, Hkv, D, dtype, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, D), dtype=np.float32)
    k = rng.standard_normal((B, S, Hkv, D), dtype=np.float32)
    v = rng.standard_normal((B, S, Hkv, D), dtype=np.float32)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jax_in = [jnp.asarray(x, jd) for x in (q, k, v)]
    torch_in = [torch.from_numpy(x).to(td) for x in (q, k, v)]
    return jax_in, torch_in


@pytest.mark.parametrize("B,S,H,Hkv,D,dtype", CASES)
def test_reference_matches_pallas_kernel(B, S, H, Hkv, D, dtype):
    (jq, jk, jv), (tq, tk, tv) = _qkv(B, S, H, Hkv, D, dtype)
    want = np.asarray(_blocked_attention(jq, jk, jv, interpret=True), np.float32)
    got = fa.attention_reference(tq, tk, tv)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    tol = 3e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(to_np(got), want, atol=tol, rtol=tol)


@pytest.mark.parametrize("B,S,H,Hkv,D,dtype", CASES)
def test_reference_matches_xla_attention(B, S, H, Hkv, D, dtype):
    (jq, jk, jv), (tq, tk, tv) = _qkv(B, S, H, Hkv, D, dtype, seed=1)
    f32 = [x.astype(jnp.float32) for x in (jq, jk, jv)]
    want = np.asarray(jax.nn.dot_product_attention(*f32))
    tol = 3e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(to_np(fa.attention_reference(tq, tk, tv)), want,
                               atol=tol, rtol=tol)


def test_reference_masks_keys_beyond_kv_len():
    (_, _, _), (q, k, v) = _qkv(1, 1032, 2, 2, 32, "float32", seed=2)
    got = fa.attention_reference(q, k, v, kv_len=1025)
    want = fa.attention_reference(q, k[:, :1025], v[:, :1025])
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("S,H,Hkv,D,tile", [(1025, 4, 2, 64, 128), (777, 2, 1, 128, 64),
                                            (777, 4, 2, 8, 128)])
def test_bf16_tolerance_passes_pallas_and_rejects_unmasked_tile_padding(S, H, Hkv, D, tile):
    """fa.BF16_TOL, the bound the card holds the bf16 kernels to, takes the
    Pallas kernel's bf16 output, and rejects what a tensor-core kernel
    without its kv_len mask would give: the keys that TMA zero-fills up to a
    whole tile of ``tile`` keys scoring 0 in the softmax."""
    (jq, jk, jv), (q, k, v) = _qkv(1, S, H, Hkv, D, "bfloat16", seed=7)
    want = fa.attention_reference(q, k, v).float()
    pallas = np.asarray(_blocked_attention(jq, jk, jv, interpret=True), np.float32)
    torch.testing.assert_close(torch.from_numpy(pallas), want, **fa.BF16_TOL)
    k0, v0 = (torch.cat([x, x.new_zeros(1, -S % tile, Hkv, D)], dim=1) for x in (k, v))
    with pytest.raises(AssertionError, match="Tensor-likes are not close"):
        torch.testing.assert_close(fa.attention_reference(q, k0, v0).float(), want,
                                   **fa.BF16_TOL)


def test_dispatcher_takes_kernel_branch_at_1024():
    """S = 1024 self-attention is kernel-eligible; on a CPU tensor that
    branch is the plain version, which matches XLA attention."""
    (jq, jk, jv), (q, k, v) = _qkv(1, 1024, 2, 2, 16, "float32", seed=3)
    assert fa.kernel_eligible(q, k)
    got = fa.fused_attention(q, k, v)
    torch.testing.assert_close(got, fa.attention_reference(q, k, v), rtol=0, atol=0)
    np.testing.assert_allclose(to_np(got), np.asarray(jax.nn.dot_product_attention(jq, jk, jv)),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dispatcher_head_dim_160_matches_the_jax_dispatcher(dtype):
    """Stable Diffusion's coarsest levels at 1024 px send the kernel head dim
    160 (both kernels take every head dim up to 256): on a CPU tensor the
    kernel branch takes the plain version, which matches the JAX
    dispatcher's result (its XLA attention on the CPU) in float32, and
    within BF16_TOL in bfloat16."""
    from audioeditingcode_tpu.ops.flash_attention import fused_attention as j_fused

    (jq, jk, jv), (q, k, v) = _qkv(1, 1024, 2, 2, 160, dtype, seed=16)
    assert fa.kernel_eligible(q, k) and 160 <= fa.MAX_KERNEL_HEAD_DIM
    got = fa.fused_attention(q, k, v)
    torch.testing.assert_close(got, fa.attention_reference(q, k, v), rtol=0, atol=0)
    want = torch.from_numpy(np.asarray(j_fused(jq, jk, jv), np.float32))
    tol = fa.BF16_TOL if dtype == "bfloat16" else {"atol": 2e-5, "rtol": 2e-5}
    torch.testing.assert_close(got.float(), want, **tol)


@pytest.mark.parametrize("S,K,masked", [(512, 512, False), (256, 8, True), (1024, 8, False)])
def test_dispatcher_plain_path_matches_xla(S, K, masked):
    """Short, cross and masked attention take the plain path, with the
    semantics of jax.nn.dot_product_attention (bias included)."""
    from audioeditingcode_tpu.models.attention import mask_to_bias as jax_bias
    from audioeditingcode_tpu_torch.models.attention import mask_to_bias

    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, S, 2, 16), dtype=np.float32)
    kv = rng.standard_normal((2, K, 2, 16), dtype=np.float32)
    mask = np.ones((2, K), np.int32)
    if masked:
        mask[0, 3:] = 0
    tb = mask_to_bias(torch.from_numpy(mask), torch.float32) if masked else None
    jb = jax_bias(jnp.asarray(mask), jnp.float32) if masked else None
    tq, tkv = torch.from_numpy(q), torch.from_numpy(kv)
    assert not fa.kernel_eligible(tq, tkv, tb)
    got = fa.fused_attention(tq, tkv, tkv, bias=tb)
    want = jax.nn.dot_product_attention(jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv), bias=jb)
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("B,S,H,Hkv,D,rot,dtype", [
    (2, 1025, 4, 2, 64, 32, "float32"),
    (1, 1025, 4, 2, 64, 32, "bfloat16"),
    (1, 1024, 2, 2, 32, 32, "float32"),
])
def test_rotary_reference_matches_pallas_kernel(B, S, H, Hkv, D, rot, dtype):
    """B2's plain version against _attn_rotary_kernel (interpret mode), at
    the DiT's ragged S = 1025 with GQA, and with the rotary over all of D."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(B, S, H, Hkv, D, dtype, seed=5)
    jcos, jsin = j_rotary_tables(rot, S)
    cos, sin = torch.from_numpy(np.array(jcos)), torch.from_numpy(np.array(jsin))
    want = np.asarray(_blocked_attention(jq, jk, jv, rotary=(jcos, jsin), interpret=True),
                      np.float32)
    got = fa.rotary_attention_reference(tq, tk, tv, cos, sin)
    tol = fa.BF16_TOL if dtype == "bfloat16" else {"atol": 2e-5, "rtol": 2e-5}
    np.testing.assert_allclose(to_np(got), want, **tol)
    # the host rotary itself is bit-equal to the JAX one
    np.testing.assert_array_equal(to_np(fa._host_rotary(tq, cos, sin)),
                                  np.asarray(_host_rotary(jq, jcos, jsin), np.float32))


@pytest.mark.parametrize("in_kernel", ["0", "1"])
def test_dispatcher_rotary_routing(in_kernel, monkeypatch):
    """With AEC_ROTARY_IN_KERNEL=1 an eligible call takes B2's plain version
    on a CPU tensor; otherwise the host rotary, then B1's. Ineligible
    (short) calls take the host rotary and the plain path. All match JAX."""
    monkeypatch.setenv("AEC_ROTARY_IN_KERNEL", in_kernel)
    from audioeditingcode_tpu.ops.flash_attention import fused_attention as j_fused

    for S in (1025, 512):
        (jq, jk, jv), (tq, tk, tv) = _qkv(1, S, 2, 1, 64, "float32", seed=6)
        jcos, jsin = j_rotary_tables(32, S)
        cos, sin = torch.from_numpy(np.array(jcos)), torch.from_numpy(np.array(jsin))
        calls = []
        ref = fa.rotary_attention_reference
        monkeypatch.setattr(fa, "rotary_attention_reference",
                            lambda *a: calls.append(1) or ref(*a))
        got = fa.fused_attention(tq, tk, tv, rotary=(cos, sin))
        assert len(calls) == (1 if in_kernel == "1" and S >= 1024 else 0)
        want = j_fused(jq, jk, jv, rotary=(jcos, jsin))
        np.testing.assert_allclose(to_np(got), np.asarray(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("B,S,H,Hkv,D,rot", [(1, 1025, 4, 2, 64, 32), (1, 777, 2, 1, 128, 64),
                                             (1, 1024, 2, 2, 32, 32)])
def test_bf16_tolerance_rejects_unrotated_keys(B, S, H, Hkv, D, rot):
    """fa.BF16_TOL, the bound the card holds bf16 B2 to, takes the Pallas
    rotary kernel's bf16 output, and rejects what a kernel that rotated q
    but left its K tiles unrotated would give, so a card check sees a lost
    (or misaddressed) K rotation."""
    (jq, jk, jv), (q, k, v) = _qkv(B, S, H, Hkv, D, "bfloat16", seed=8)
    jcos, jsin = j_rotary_tables(rot, S)
    cos, sin = torch.from_numpy(np.array(jcos)), torch.from_numpy(np.array(jsin))
    want = fa.rotary_attention_reference(q, k, v, cos, sin).float()
    pallas = np.asarray(_blocked_attention(jq, jk, jv, rotary=(jcos, jsin), interpret=True),
                        np.float32)
    torch.testing.assert_close(torch.from_numpy(pallas), want, **fa.BF16_TOL)
    unrotated_k = fa.attention_reference(fa._host_rotary(q, cos, sin), k, v).float()
    with pytest.raises(AssertionError, match="Tensor-likes are not close"):
        torch.testing.assert_close(unrotated_k, want, **fa.BF16_TOL)


@pytest.mark.parametrize("dtype,rotary,route", [
    (torch.bfloat16, False, fa.TENSOR_CORE),
    (torch.float32, False, fa.TF32X3),
    (torch.bfloat16, True, fa.TENSOR_CORE),
    (torch.float32, True, fa.TF32X3),
])
def test_attention_route(dtype, rotary, route):
    """bfloat16 B1 and B2 go to the bf16 tensor-core kernel, float32 B1 and
    B2 to the 3xTF32 one."""
    assert fa.attention_route(dtype, rotary=rotary) == route


def _rna_split(x: torch.Tensor):
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def _tf32_matmul(a: torch.Tensor, b: torch.Tensor, split=None) -> torch.Tensor:
    """a @ b from TF32 parts: lo·hi + hi·lo + hi·hi with the operands cut by
    ``split`` (the float32 kernel's 3xTF32), or one TF32 product."""
    if split is None:
        return tf32_round(a) @ tf32_round(b)
    (ah, al), (bh, bl) = split(a), split(b)
    return (al @ bh + ah @ bl) + ah @ bh


def _tf32_attention(q, k, v, split=None) -> torch.Tensor:
    """The float32 kernel's arithmetic with its two products emulated: q
    split after q * scale, p after the exponential."""
    H, D = q.shape[2], q.shape[3]
    qs = (q * (1.0 / D ** 0.5)).transpose(1, 2)
    kt, vt = (fa._repeat_kv(x, H).transpose(1, 2) for x in (k, v))
    s = _tf32_matmul(qs, kt.transpose(-1, -2), split)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return (_tf32_matmul(p, vt, split) / p.sum(dim=-1, keepdim=True)).transpose(1, 2)


@pytest.mark.parametrize("D", [16, 64, 128])
def test_f32_tolerance_takes_3xtf32_and_rejects_one_tf32_product(D):
    """fa.F32_TOL, the bound the card holds the float32 kernels to, takes
    attention whose products are three TF32 products (about 0.1 of it, with
    rna parts or the kernel's) and rejects one TF32 product (about 25-50
    times it), so a card check sees a kernel that lost its lo terms."""
    (_, _, _), (q, k, v) = _qkv(1, 256, 4, 2, D, "float32", seed=9)
    want = fa.attention_reference(q, k, v)
    assert torch.equal(tf32_round(torch.tensor([1 + 2 ** -11, -1 - 3 * 2 ** -11])),
                       torch.tensor([1 + 2 ** -10, -1 - 2 ** -9]))  # ties away from zero
    for split in (_rna_split, tf32_split):
        hi, lo = split(q)
        assert not (hi.view(torch.int32) & 0x1FFF).any() and (hi + lo - q).abs().max() > 0
        torch.testing.assert_close(_tf32_attention(q, k, v, split), want, **fa.F32_TOL)
    with pytest.raises(AssertionError, match="Tensor-likes are not close"):
        torch.testing.assert_close(_tf32_attention(q, k, v), want, **fa.F32_TOL)


def test_attention_route_rejects_other_dtypes():
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.attention_route(torch.float16)


def test_cuda_wrapper_rejects_cpu_tensors_without_counting():
    (_, _, _), (q, k, v) = _qkv(1, 1024, 2, 2, 16, "bfloat16")
    before = (fa.flash_attention_cuda.launches, dict(fa.flash_attention_cuda.launches_by_route))
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention_cuda(q, k, v)
    assert (fa.flash_attention_cuda.launches,
            fa.flash_attention_cuda.launches_by_route) == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rotary_wrapper_rejects_cpu_tensors_without_counting(dtype):
    (_, _, _), (q, k, v) = _qkv(1, 1024, 2, 2, 32, dtype)
    cos, sin = torch.ones(1024, 16), torch.zeros(1024, 16)
    wrapper = fa.flash_attention_rotary_cuda
    before = (wrapper.launches, dict(wrapper.launches_by_route))
    with pytest.raises(ValueError, match="CUDA tensors"):
        wrapper(q, k, v, cos, sin)
    assert (wrapper.launches, wrapper.launches_by_route) == before
