"""The port's CUDA kernels on the card, against their plain versions.

These need an NVIDIA GPU and nvcc; they skip without one. On a machine
with a card run them with ``python -m pytest --noconftest tests/test_torch_cuda.py -q``
(``--noconftest``: the suite's conftest imports JAX, which a PyTorch-only install lacks).
Tolerances: float32 attention (B1 and B2, products in 3xTF32) to
``fa.F32_TOL`` (1e-5 + 1e-5 |ref|: a kernel with a single TF32 product
fails it) and float32 SwiGLU (products in 3xTF32) to ``swiglu.F32_TOL``,
the same bound; bfloat16 attention to ``fa.BF16_TOL`` (two bf16 ulps, 4e-3
near zero: tight enough that a kernel which dropped its kv_len mask or its
K rotation fails) and bfloat16 SwiGLU to ``swiglu.BF16_TOL``, the same
bound (a kernel that skipped a 64-feature slice of E fails it). The bounds
are pinned in tests/test_torch_flash_attention.py and
tests/test_torch_swiglu.py. Power iteration on the tiny models, card
against CPU, is held to the bounds of tests/test_torch_pc_drift.py.
"""

import pytest
import torch

from audioeditingcode_tpu_torch.models.dit1d import rotary_tables
from audioeditingcode_tpu_torch.ops import flash_attention as fa
from audioeditingcode_tpu_torch.ops import swiglu
from audioeditingcode_tpu_torch.utils.device import resolve_device

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return resolve_device("cuda")  # also turns TF32 off for the float32 reference


@pytest.mark.parametrize("B,S,H,Hkv,D", [(2, 4096, 8, 8, 16), (2, 1024, 8, 8, 32),
                                         (2, 1025, 24, 12, 64), (1, 777, 2, 1, 128),
                                         (1, 1000, 3, 3, 8),
                                         # AudioLDM-l and TANGO (bf16 pads D 40, 80)
                                         (2, 4096, 8, 8, 32), (2, 1024, 8, 8, 64),
                                         (2, 4096, 8, 8, 40), (2, 1024, 8, 8, 80),
                                         # SD v1.4 at 1024 px's coarsest levels
                                         (2, 1024, 8, 8, 160), (1, 1100, 4, 2, 160)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_version(cuda, B, S, H, Hkv, D, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(B, S, H, D, device=cuda, generator=g).to(dtype)
    k = torch.randn(B, S, Hkv, D, device=cuda, generator=g).to(dtype)
    v = torch.randn(B, S, Hkv, D, device=cuda, generator=g).to(dtype)
    got = fa.flash_attention_cuda(q, k, v)
    torch.cuda.synchronize()
    tol = fa.BF16_TOL if dtype == torch.bfloat16 else fa.F32_TOL
    torch.testing.assert_close(got.float(), fa.attention_reference(q, k, v).float(), **tol)


def test_kernel_masks_kv_len_and_reads_strides(cuda):
    q = torch.randn(1, 1032, 2, 32, device=cuda)
    kv = torch.randn(1, 2, 1032, 32, device=cuda).transpose(1, 2)  # strided heads
    got = fa.flash_attention_cuda(q, kv, kv, kv_len=1025)
    want = fa.attention_reference(q, kv[:, :1025], kv[:, :1025])
    torch.testing.assert_close(got, want, **fa.F32_TOL)


def test_dispatcher_launches_kernel_or_raises(cuda):
    q = torch.randn(1, 1024, 2, 16, device=cuda)
    before = fa.flash_attention_cuda.launches
    fa.fused_attention(q, q, q)
    assert fa.flash_attention_cuda.launches == before + 1
    fa.fused_attention(q[:, :512], q[:, :512], q[:, :512])  # below the threshold
    assert fa.flash_attention_cuda.launches == before + 1
    wide = torch.randn(1, 1024, 1, 136, device=cuda)  # D > 128 launches too
    fa.fused_attention(wide, wide, wide)
    assert fa.flash_attention_cuda.launches == before + 2
    wider = torch.randn(1, 1024, 1, 264, device=cuda)  # D > 256: the plain path
    fa.fused_attention(wider, wider, wider)
    assert fa.flash_attention_cuda.launches == before + 2
    half = q.half()  # eligible, but a dtype no kernel takes: raises, no fallback
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.fused_attention(half, half, half)


@pytest.mark.parametrize("B,S,H,Hkv,D,rot", [(2, 1025, 24, 12, 64, 32), (1, 1024, 2, 2, 32, 32),
                                             (1, 777, 4, 1, 128, 64), (1, 1000, 3, 3, 8, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rotary_kernel_matches_plain_version(cuda, B, S, H, Hkv, D, rot, dtype):
    g = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn(B, S, H, D, device=cuda, generator=g).to(dtype)
    k = torch.randn(B, S, Hkv, D, device=cuda, generator=g).to(dtype)
    v = torch.randn(B, S, Hkv, D, device=cuda, generator=g).to(dtype)
    cos, sin = rotary_tables(rot, S + 3, device=cuda)  # longer tables are fine
    got = fa.flash_attention_rotary_cuda(q, k, v, cos, sin)
    torch.cuda.synchronize()
    tol = fa.BF16_TOL if dtype == torch.bfloat16 else fa.F32_TOL
    torch.testing.assert_close(got.float(),
                               fa.rotary_attention_reference(q, k, v, cos, sin).float(), **tol)


def test_rotary_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.randn(1, 1024, 2, 32, device=cuda)
    cos, sin = rotary_tables(32, 1024, device=cuda)
    with pytest.raises(ValueError, match="square"):
        fa.flash_attention_rotary_cuda(q, q[:, :512], q[:, :512], cos, sin)
    with pytest.raises(ValueError, match="even"):
        fa.flash_attention_rotary_cuda(q, q, q, cos[:, :3], sin[:, :3])
    with pytest.raises(ValueError, match="positions"):
        fa.flash_attention_rotary_cuda(q, q, q, cos[:100], sin[:100])
    q264 = torch.randn(1, 1024, 2, 264, device=cuda)
    with pytest.raises(ValueError, match="head dim 264: the kernels take head dims up to 256"):
        fa.flash_attention_rotary_cuda(q264, q264, q264, cos, sin)


def test_dispatcher_routes_rotary(cuda, monkeypatch):
    q = torch.randn(1, 1025, 4, 64, device=cuda)
    kv = torch.randn(1, 1025, 2, 64, device=cuda)
    rot = rotary_tables(32, 1025, device=cuda)
    b1, b2 = fa.flash_attention_cuda.launches, fa.flash_attention_rotary_cuda.launches
    host = fa.fused_attention(q, kv, kv, rotary=rot)
    assert (fa.flash_attention_cuda.launches, fa.flash_attention_rotary_cuda.launches) == (b1 + 1, b2)
    monkeypatch.setenv("AEC_ROTARY_IN_KERNEL", "1")
    inside = fa.fused_attention(q, kv, kv, rotary=rot)
    assert (fa.flash_attention_cuda.launches, fa.flash_attention_rotary_cuda.launches) == (b1 + 1, b2 + 1)
    torch.testing.assert_close(inside, host, **fa.F32_TOL)


@pytest.mark.parametrize("M,E,N", [(2050, 1536, 6144), (1025, 1536, 6144), (512, 128, 128),
                                   (77, 256, 192)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_swiglu_kernel_matches_plain_version(cuda, M, E, N, dtype):
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(M, E, device=cuda, generator=g).to(dtype)
    w = (torch.randn(2 * N, E, device=cuda, generator=g) / E ** 0.5).to(dtype)
    b = torch.randn(2 * N, device=cuda, generator=g) * 0.1
    got = swiglu.swiglu_cuda(x, w, b)
    torch.cuda.synchronize()
    tol = swiglu.BF16_TOL if dtype == torch.bfloat16 else swiglu.F32_TOL
    torch.testing.assert_close(got.float(), swiglu.swiglu_reference(x, w, b).float(), **tol)


def test_swiglu_dispatcher_launches_kernel_or_raises(cuda):
    x = torch.randn(2, 256, 128, device=cuda)
    w, b = torch.randn(256, 128, device=cuda), torch.zeros(256, device=cuda)
    before = swiglu.swiglu_cuda.launches
    swiglu.fused_swiglu(x, w, b)
    assert swiglu.swiglu_cuda.launches == before + 1
    swiglu.fused_swiglu(x[:, :100], w, b)  # below the row threshold
    assert swiglu.swiglu_cuda.launches == before + 1
    with pytest.raises(ValueError, match="one dtype"):
        swiglu.swiglu_cuda(x[0], w.double(), b)


# --- the tensor-core routes (bfloat16): csrc/flash_attention_tc.cu, csrc/swiglu_tc.cu


def _bf16_qkv(cuda, B, S, H, Hkv, D, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return [torch.randn(B, S, h, D, device=cuda, generator=g).to(torch.bfloat16)
            for h in (H, Hkv, Hkv)]


@pytest.mark.parametrize("D", range(8, 129, 8))
@pytest.mark.parametrize("S", [777, 1025])
def test_tensor_core_attention_every_head_dim(cuda, D, S):
    """Every D the padded widths (16, 32, 64, 128) cover, at ragged S, with GQA."""
    q, k, v = _bf16_qkv(cuda, 1, S, 4, 2, D, seed=D)
    before = dict(fa.flash_attention_cuda.launches_by_route)
    got = fa.flash_attention_cuda(q, k, v)
    torch.cuda.synchronize()
    assert fa.flash_attention_cuda.launches_by_route[fa.TENSOR_CORE] == before[fa.TENSOR_CORE] + 1
    assert fa.flash_attention_cuda.launches_by_route[fa.TF32X3] == before[fa.TF32X3]
    torch.testing.assert_close(got.float(), fa.attention_reference(q, k, v).float(),
                               **fa.BF16_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head_dim_160_masks_kv_len_and_takes_sp_query_blocks(cuda, dtype):
    """D = 160 (f32: 32-key tiles; bf16: DP 192, one consumer warpgroup):
    the sp route's query blocks against the padded K/V with kv_len give the
    unsharded kernel's rows bit for bit; D = 152 takes the same instances
    with its features zero-filled, and D = 264 raises."""
    g = torch.Generator(device=cuda).manual_seed(16)
    q, k, v = (torch.randn(1, 1040, h, 160, device=cuda, generator=g).to(dtype)
               for h in (4, 2, 2))
    tol = fa.BF16_TOL if dtype == torch.bfloat16 else fa.F32_TOL
    whole = fa.flash_attention_cuda(q[:, :1025], k[:, :1025], v[:, :1025])
    torch.testing.assert_close(
        whole.float(), fa.attention_reference(q[:, :1025], k[:, :1025], v[:, :1025]).float(),
        **tol)
    for r in range(2):
        part = fa.flash_attention_cuda(q[:, 520 * r: 520 * (r + 1)], k, v, kv_len=1025)
        n = min(520, 1025 - 520 * r)
        assert torch.equal(part[:, :n], whole[:, 520 * r: 520 * r + n])
    q152, k152, v152 = (x[:, :1025, :, :152] for x in (q, k, v))
    torch.testing.assert_close(fa.flash_attention_cuda(q152, k152, v152).float(),
                               fa.attention_reference(q152, k152, v152).float(), **tol)
    wide = torch.randn(1, 1024, 1, 264, device=cuda).to(dtype)
    with pytest.raises(ValueError, match="head dim 264"):
        fa.flash_attention_cuda(wide, wide, wide)


# head dims beside the instances' widths: not multiples of 8 (f32: zero
# fill in the kernel; bf16: a zero-padded copy), 136-160 (f32 160, bf16 DP
# 192), 168-192 (f32 192 in two 96-column blocks, bf16 DP 192) and 200-256
# (f32 256 and bf16 DP 256, each in two 128-column blocks)
WIDE_HEAD_DIMS = [1, 7, 20, 36, 100, 136, 144, 152, 168, 176, 184, 192, 200, 232, 248, 256]


@pytest.mark.parametrize("D", WIDE_HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_every_head_dim_up_to_256(cuda, D, dtype):
    """B1 at every kind of head dim the JAX kernel takes, ragged S and GQA,
    on its dtype's route; only a bf16 D off a multiple of 8 pads a copy."""
    g = torch.Generator(device=cuda).manual_seed(D)
    q, k, v = (torch.randn(1, 1025, h, D, device=cuda, generator=g).to(dtype)
               for h in (4, 2, 2))
    before = dict(fa.flash_attention_cuda.launches_by_route)
    pads = fa.flash_attention_cuda.pad_copies
    got = fa.flash_attention_cuda(q, k, v)
    torch.cuda.synchronize()
    route = fa.attention_route(dtype)
    assert fa.flash_attention_cuda.launches_by_route[route] == before[route] + 1
    assert fa.flash_attention_cuda.pad_copies == pads + (dtype == torch.bfloat16 and D % 8 != 0)
    assert got.shape == q.shape and got.is_contiguous()
    tol = fa.BF16_TOL if dtype == torch.bfloat16 else fa.F32_TOL
    torch.testing.assert_close(got.float(), fa.attention_reference(q, k, v).float(), **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head_dim_256_takes_sp_query_blocks_and_ragged_gqa(cuda, dtype):
    """The sp route's query block at D = 256 (264 rows of 1056 padded keys,
    kv_len 1025) gives the whole kernel's rows bit for bit; a ragged GQA
    call at D = 200 with kv_len matches the plain version."""
    g = torch.Generator(device=cuda).manual_seed(256)
    q, k, v = (torch.randn(2, 1056, h, 256, device=cuda, generator=g).to(dtype)
               for h in (8, 8, 8))
    tol = fa.BF16_TOL if dtype == torch.bfloat16 else fa.F32_TOL
    whole = fa.flash_attention_cuda(q[:, :1025], k[:, :1025], v[:, :1025])
    part = fa.flash_attention_cuda(q[:, 264:528], k, v, kv_len=1025)
    assert torch.equal(part, whole[:, 264:528])
    torch.testing.assert_close(
        part.float(), fa.attention_reference(q[:, 264:528], k, v, kv_len=1025).float(), **tol)
    q, k, v = (torch.randn(1, 777, h, 200, device=cuda, generator=g).to(dtype)
               for h in (4, 2, 2))
    torch.testing.assert_close(fa.flash_attention_cuda(q, k, v, kv_len=700).float(),
                               fa.attention_reference(q, k, v, kv_len=700).float(), **tol)


@pytest.mark.parametrize("D,rot", [(20, 10), (100, 64), (136, 136), (160, 64), (200, 64),
                                   (200, 200), (256, 64), (256, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rotary_every_head_dim_up_to_256(cuda, D, rot, dtype):
    """B2 above head dim 128 and off multiples of 8, with rot = 64 (the
    DiT's) and rot = D, against its plain version."""
    g = torch.Generator(device=cuda).manual_seed(D + rot)
    q, k, v = (torch.randn(2, 1025, h, D, device=cuda, generator=g).to(dtype)
               for h in (4, 2, 2))
    cos, sin = rotary_tables(rot, 1025, device=cuda)
    before = dict(fa.flash_attention_rotary_cuda.launches_by_route)
    got = fa.flash_attention_rotary_cuda(q, k, v, cos, sin)
    torch.cuda.synchronize()
    route = fa.attention_route(dtype, rotary=True)
    assert fa.flash_attention_rotary_cuda.launches_by_route[route] == before[route] + 1
    tol = fa.BF16_TOL if dtype == torch.bfloat16 else fa.F32_TOL
    torch.testing.assert_close(got.float(),
                               fa.rotary_attention_reference(q, k, v, cos, sin).float(), **tol)


def test_tensor_core_attention_masks_kv_len_and_reads_strided_heads(cuda):
    g = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn(2, 1032, 6, 64, device=cuda, generator=g).to(torch.bfloat16)
    kv = torch.randn(2, 3, 1032, 64, device=cuda, generator=g).to(torch.bfloat16)
    kv = kv.transpose(1, 2)  # strided heads, 3 kv heads for 6 q heads
    got = fa.flash_attention_cuda(q, kv, kv, kv_len=1025)
    want = fa.attention_reference(q, kv[:, :1025], kv[:, :1025])
    torch.testing.assert_close(got.float(), want.float(), **fa.BF16_TOL)


def test_tensor_core_attention_is_deterministic(cuda):
    q, k, v = _bf16_qkv(cuda, 2, 1025, 24, 12, 64, seed=4)
    first = fa.flash_attention_cuda(q, k, v)
    second = fa.flash_attention_cuda(q, k, v)
    assert torch.equal(first, second)


def test_tensor_core_attention_rejects_what_tma_cannot_take(cuda):
    base = torch.randn(1, 1024, 2, 24, device=cuda).to(torch.bfloat16)
    misaligned = base[..., 4:20]  # head dim 16, base 8 bytes past a 16-byte boundary
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_attention_cuda(misaligned, misaligned, misaligned)
    odd_stride = torch.randn(1, 1024, 2, 20, device=cuda).to(torch.bfloat16)[..., :16]
    with pytest.raises(ValueError, match="multiples of 8"):
        fa.flash_attention_cuda(odd_stride, odd_stride, odd_stride)


def test_float32_on_tf32x3_route_and_bf16_rotary_on_tensor_cores(cuda):
    """float32 B1 and B2 launch the 3xTF32 kernel, bfloat16 B2 the bf16
    tensor-core one; each raises only its own wrapper's route count."""
    q = torch.randn(1, 1024, 2, 32, device=cuda)
    cos, sin = rotary_tables(32, 1024, device=cuda)
    b1 = dict(fa.flash_attention_cuda.launches_by_route)
    fa.flash_attention_cuda(q, q, q)
    assert fa.flash_attention_cuda.launches_by_route == {
        fa.TF32X3: b1[fa.TF32X3] + 1, fa.TENSOR_CORE: b1[fa.TENSOR_CORE]}
    b2 = dict(fa.flash_attention_rotary_cuda.launches_by_route)
    fa.flash_attention_rotary_cuda(q, q, q, cos, sin)
    qb = q.to(torch.bfloat16)
    fa.flash_attention_rotary_cuda(qb, qb, qb, cos, sin)
    assert fa.flash_attention_rotary_cuda.launches_by_route == {
        fa.TF32X3: b2[fa.TF32X3] + 1, fa.TENSOR_CORE: b2[fa.TENSOR_CORE] + 1}
    assert fa.flash_attention_cuda.launches_by_route[fa.TF32X3] == b1[fa.TF32X3] + 1


# (D, rot): every padded width DP (16, 32, 64, 128) with rot = D/2 and rot = D,
# D below a width (40, 24), an odd rot/2 (rot 6, 10), and at D = 128 a rot
# whose pairs cross the two 128-byte column blocks (96). rot % 16 == 0 takes
# the K rotation in 16-byte chunks, the others (8, 20, 40, 10, 6) per pair.
ROTARY_TC_CASES = [(16, 8), (16, 16), (32, 16), (32, 32), (64, 32), (64, 64), (128, 64),
                   (128, 128), (128, 96), (40, 20), (40, 10), (24, 6)]


@pytest.mark.parametrize("D,rot", ROTARY_TC_CASES)
@pytest.mark.parametrize("S", [777, 1025])
def test_tensor_core_rotary_attention_every_width(cuda, D, rot, S):
    """bf16 B2 on the tensor cores against its plain version, at ragged S,
    with GQA and tables longer than the sequence."""
    q, k, v = _bf16_qkv(cuda, 1, S, 4, 2, D, seed=D + rot)
    cos, sin = rotary_tables(rot, S + 5, device=cuda)
    before = dict(fa.flash_attention_rotary_cuda.launches_by_route)
    got = fa.flash_attention_rotary_cuda(q, k, v, cos, sin)
    torch.cuda.synchronize()
    assert fa.flash_attention_rotary_cuda.launches_by_route == {
        fa.TENSOR_CORE: before[fa.TENSOR_CORE] + 1, fa.TF32X3: before[fa.TF32X3]}
    torch.testing.assert_close(got.float(),
                               fa.rotary_attention_reference(q, k, v, cos, sin).float(),
                               **fa.BF16_TOL)


def test_tensor_core_rotary_attention_reads_strided_heads(cuda):
    g = torch.Generator(device=cuda).manual_seed(7)
    q = torch.randn(2, 6, 1025, 64, device=cuda, generator=g).to(torch.bfloat16)
    kv = torch.randn(2, 3, 1025, 64, device=cuda, generator=g).to(torch.bfloat16)
    q, kv = q.transpose(1, 2), kv.transpose(1, 2)  # strided heads, 3 kv heads for 6
    cos, sin = rotary_tables(32, 2048, device=cuda)
    got = fa.flash_attention_rotary_cuda(q, kv, kv, cos, sin)
    want = fa.rotary_attention_reference(q, kv, kv, cos, sin)
    torch.testing.assert_close(got.float(), want.float(), **fa.BF16_TOL)


def test_tensor_core_rotary_attention_misaligned_tables(cuda):
    """Tables that are not 16-byte aligned take the per-pair K rotation even
    where rot is a multiple of 16 (the chunk path reads them as float4)."""
    q, k, v = _bf16_qkv(cuda, 1, 1025, 4, 2, 64, seed=9)
    tables = rotary_tables(32, 1025, device=cuda)
    cos, sin = (torch.cat([x.new_zeros(1), x.flatten()])[1:].view(1025, 32) for x in tables)
    assert cos.data_ptr() % 16 and torch.equal(cos, tables[0])
    got = fa.flash_attention_rotary_cuda(q, k, v, cos, sin)
    torch.testing.assert_close(got.float(),
                               fa.rotary_attention_reference(q, k, v, *tables).float(),
                               **fa.BF16_TOL)


def test_tensor_core_rotary_attention_is_deterministic(cuda):
    q, k, v = _bf16_qkv(cuda, 2, 1025, 24, 12, 64, seed=8)
    cos, sin = rotary_tables(32, 1025, device=cuda)
    first = fa.flash_attention_rotary_cuda(q, k, v, cos, sin)
    second = fa.flash_attention_rotary_cuda(q, k, v, cos, sin)
    assert torch.equal(first, second)


def test_tensor_core_rotary_attention_rejects_what_tma_cannot_take(cuda):
    """No fallback to the CUDA cores: a bf16 call the TMA loads cannot take
    raises and counts no launch."""
    cos, sin = rotary_tables(16, 1024, device=cuda)
    odd_stride = torch.randn(1, 1024, 2, 20, device=cuda).to(torch.bfloat16)[..., :16]
    before = dict(fa.flash_attention_rotary_cuda.launches_by_route)
    with pytest.raises(ValueError, match="multiples of 8"):
        fa.flash_attention_rotary_cuda(odd_stride, odd_stride, odd_stride, cos, sin)
    assert fa.flash_attention_rotary_cuda.launches_by_route == before


# --- the float32 attention route: csrc/flash_attention.cu, products in 3xTF32


def _f32_qkv(cuda, B, S, H, Hkv, D, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return [torch.randn(B, S, h, D, device=cuda, generator=g) for h in (H, Hkv, Hkv)]


@pytest.mark.parametrize("D", range(8, 129, 8))
@pytest.mark.parametrize("S", [1024, 1025])
def test_tf32x3_attention_every_head_dim(cuda, D, S):
    """float32 B1 at every D (an instance each), with a whole and a ragged
    last key tile and GQA, held to fa.F32_TOL."""
    q, k, v = _f32_qkv(cuda, 1, S, 4, 2, D, seed=D)
    before = dict(fa.flash_attention_cuda.launches_by_route)
    got = fa.flash_attention_cuda(q, k, v)
    torch.cuda.synchronize()
    assert fa.flash_attention_cuda.launches_by_route == {
        fa.TF32X3: before[fa.TF32X3] + 1, fa.TENSOR_CORE: before[fa.TENSOR_CORE]}
    torch.testing.assert_close(got, fa.attention_reference(q, k, v), **fa.F32_TOL)


# (D, rot): rot 2, D/2 and D across the head dims, and rots that are not
# multiples of 8 (6, 10, 12, 20, 36, 96 / 2 = 48 pairs)
ROTARY_F32_CASES = [(8, 2), (8, 4), (8, 8), (16, 2), (16, 8), (16, 16), (24, 6), (24, 12),
                    (32, 2), (32, 16), (32, 32), (40, 10), (40, 20), (64, 2), (64, 32),
                    (64, 64), (72, 36), (128, 2), (128, 64), (128, 96), (128, 128)]


@pytest.mark.parametrize("D,rot", ROTARY_F32_CASES)
@pytest.mark.parametrize("S", [777, 1025])
def test_tf32x3_rotary_attention_every_width(cuda, D, rot, S):
    """float32 B2 against its plain version, at ragged S, with GQA and
    tables longer than the sequence."""
    q, k, v = _f32_qkv(cuda, 1, S, 4, 2, D, seed=D + rot)
    cos, sin = rotary_tables(rot, S + 5, device=cuda)
    before = dict(fa.flash_attention_rotary_cuda.launches_by_route)
    got = fa.flash_attention_rotary_cuda(q, k, v, cos, sin)
    torch.cuda.synchronize()
    assert fa.flash_attention_rotary_cuda.launches_by_route == {
        fa.TF32X3: before[fa.TF32X3] + 1, fa.TENSOR_CORE: before[fa.TENSOR_CORE]}
    torch.testing.assert_close(got, fa.rotary_attention_reference(q, k, v, cos, sin),
                               **fa.F32_TOL)


def test_tf32x3_attention_masks_kv_len_and_reads_strided_heads(cuda):
    g = torch.Generator(device=cuda).manual_seed(10)
    q = torch.randn(2, 6, 1032, 64, device=cuda, generator=g).transpose(1, 2)
    kv = torch.randn(2, 3, 1032, 64, device=cuda, generator=g).transpose(1, 2)
    got = fa.flash_attention_cuda(q, kv, kv, kv_len=1025)  # 3 kv heads for 6
    want = fa.attention_reference(q, kv[:, :1025], kv[:, :1025])
    torch.testing.assert_close(got, want, **fa.F32_TOL)


def test_tf32x3_attention_takes_unaligned_rows(cuda):
    """K/V rows that are not 16-byte aligned (a base 8 bytes past a boundary,
    or strides of 17 floats) take the kernel's 4-byte copies, in B1 and B2."""
    g = torch.Generator(device=cuda).manual_seed(11)
    q = torch.randn(1, 1025, 4, 16, device=cuda, generator=g)
    shifted = torch.randn(1, 1025, 2, 20, device=cuda, generator=g)[..., 2:18]
    odd = torch.randn(1, 1025, 2, 17, device=cuda, generator=g)[..., :16]
    cos, sin = rotary_tables(8, 1025, device=cuda)
    for kv in (shifted, odd):
        torch.testing.assert_close(fa.flash_attention_cuda(q, kv, kv),
                                   fa.attention_reference(q, kv, kv), **fa.F32_TOL)
        torch.testing.assert_close(fa.flash_attention_rotary_cuda(q, kv, kv, cos, sin),
                                   fa.rotary_attention_reference(q, kv, kv, cos, sin),
                                   **fa.F32_TOL)


@pytest.mark.parametrize("rotary", [False, True])
def test_tf32x3_attention_is_deterministic(cuda, rotary):
    q, k, v = _f32_qkv(cuda, 2, 1025, 24, 12, 64, seed=12)
    cos, sin = rotary_tables(32, 1025, device=cuda)
    if rotary:
        first, second = (fa.flash_attention_rotary_cuda(q, k, v, cos, sin) for _ in range(2))
    else:
        first, second = (fa.flash_attention_cuda(q, k, v) for _ in range(2))
    assert torch.equal(first, second)


@pytest.mark.parametrize("S,H,Hkv,D,rot", [(1025, 24, 12, 64, 32), (777, 4, 2, 128, 64),
                                           (1024, 2, 2, 24, 6), (1000, 3, 3, 8, 8)])
def test_tf32x3_rotary_is_bit_equal_to_host_rotary_then_b1(cuda, S, H, Hkv, D, rot):
    """B2 rotates q and K in f32 as the host rotary does, then runs B1's
    products in B1's order: its output is B1's on host-rotated q and k."""
    q, k, v = _f32_qkv(cuda, 1, S, H, Hkv, D, seed=S + D)
    cos, sin = rotary_tables(rot, S, device=cuda)
    got = fa.flash_attention_rotary_cuda(q, k, v, cos, sin)
    want = fa.flash_attention_cuda(fa._host_rotary(q, cos, sin), fa._host_rotary(k, cos, sin), v)
    assert torch.equal(got, want)


@pytest.mark.parametrize("M,E,N", [(2050, 1536, 6144), (77, 256, 192), (130, 80, 320),
                                   (1, 16, 64)])
def test_tensor_core_swiglu_matches_plain_version(cuda, M, E, N):
    """Ragged M, N % 128 != 0 and an E that is not a multiple of the 64-wide slice."""
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(M, E, device=cuda, generator=g).to(torch.bfloat16)
    w = (torch.randn(2 * N, E, device=cuda, generator=g) / E ** 0.5).to(torch.bfloat16)
    b = torch.randn(2 * N, device=cuda, generator=g) * 0.1
    before = dict(swiglu.swiglu_cuda.launches_by_route)
    got = swiglu.swiglu_cuda(x, w, b)
    torch.cuda.synchronize()
    assert swiglu.swiglu_cuda.launches_by_route == {
        swiglu.TENSOR_CORE: before[swiglu.TENSOR_CORE] + 1,
        swiglu.TF32X3: before[swiglu.TF32X3]}
    torch.testing.assert_close(got.float(), swiglu.swiglu_reference(x, w, b).float(),
                               **swiglu.BF16_TOL)
    assert torch.equal(got, swiglu.swiglu_cuda(x, w, b))  # deterministic


@pytest.mark.parametrize("M,E,N,more_tiles_than_sms", [
    (2050, 1536, 6144, True),  # 816 tiles: each of the 132 blocks walks 6 or 7
    (1025, 1536, 6144, True),  # the last row block's second consumer lies past M
    (300, 64, 16384, True),  # 384 tiles at few rows and one slice of E
    (77, 1536, 192, False),  # the second half tile crosses N
    (1, 64, 320, False),  # M = 1; the third half tile crosses N
    (64, 128, 128, False),  # the second consumer's rows all past M
])
def test_tensor_core_swiglu_persistent_walk(cuda, M, E, N, more_tiles_than_sms):
    """B3-tc's persistent blocks, with more tiles than SMs and fewer, half
    tiles past N (two weight maps, stores clipped to N) and consumers whose
    rows all lie past M: held to BF16_TOL, bit-equal on a rerun, counted on
    the tensor-core route."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert (-(-M // 128) * -(-N // 128) > sms) == more_tiles_than_sms
    g = torch.Generator(device=cuda).manual_seed(8)
    x = torch.randn(M, E, device=cuda, generator=g).to(torch.bfloat16)
    w = (torch.randn(2 * N, E, device=cuda, generator=g) / E ** 0.5).to(torch.bfloat16)
    b = torch.randn(2 * N, device=cuda, generator=g) * 0.1
    before = dict(swiglu.swiglu_cuda.launches_by_route)
    got = swiglu.swiglu_cuda(x, w, b)
    torch.cuda.synchronize()
    assert swiglu.swiglu_cuda.launches_by_route == {
        swiglu.TENSOR_CORE: before[swiglu.TENSOR_CORE] + 1,
        swiglu.TF32X3: before[swiglu.TF32X3]}
    torch.testing.assert_close(got.float(), swiglu.swiglu_reference(x, w, b).float(),
                               **swiglu.BF16_TOL)
    assert torch.equal(got, swiglu.swiglu_cuda(x, w, b))


def test_float32_swiglu_on_tf32x3_route(cuda):
    g = torch.Generator(device=cuda).manual_seed(6)
    x = torch.randn(512, 128, device=cuda, generator=g)
    w = torch.randn(256, 128, device=cuda, generator=g) / 128 ** 0.5
    b = torch.randn(256, device=cuda, generator=g) * 0.1
    before = dict(swiglu.swiglu_cuda.launches_by_route)
    got = swiglu.swiglu_cuda(x, w, b)
    assert swiglu.swiglu_cuda.launches_by_route == {
        swiglu.TF32X3: before[swiglu.TF32X3] + 1,
        swiglu.TENSOR_CORE: before[swiglu.TENSOR_CORE]}
    torch.testing.assert_close(got, swiglu.swiglu_reference(x, w, b), **swiglu.F32_TOL)


# --- the float32 SwiGLU route: csrc/swiglu.cu, products in 3xTF32


@pytest.mark.parametrize("M,E,N", [(2050, 1536, 6144), (1025, 1536, 6144), (77, 80, 192),
                                   (130, 1552, 320), (1, 16, 64), (300, 48, 128)])
def test_tf32x3_swiglu_matches_plain_version(cuda, M, E, N):
    """float32 B3 held to swiglu.F32_TOL: the DiT shapes; ragged M; E not a
    multiple of the 32-feature stage (80, 1552, 48: TMA's zero fill); N % 128
    != 0 (192, 320); M = 1. Deterministic, and counted on its route."""
    g = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn(M, E, device=cuda, generator=g)
    w = torch.randn(2 * N, E, device=cuda, generator=g) / E ** 0.5
    b = torch.randn(2 * N, device=cuda, generator=g) * 0.1
    before = dict(swiglu.swiglu_cuda.launches_by_route)
    got = swiglu.swiglu_cuda(x, w, b)
    torch.cuda.synchronize()
    assert swiglu.swiglu_cuda.launches_by_route == {
        swiglu.TF32X3: before[swiglu.TF32X3] + 1,
        swiglu.TENSOR_CORE: before[swiglu.TENSOR_CORE]}
    torch.testing.assert_close(got, swiglu.swiglu_reference(x, w, b), **swiglu.F32_TOL)
    assert torch.equal(got, swiglu.swiglu_cuda(x, w, b))


def test_tf32x3_swiglu_rejects_what_it_does_not_take(cuda):
    """No fallback: E % 16 != 0, N % 64 != 0 and an x that is not 16-byte
    aligned raise and count no launch."""
    x = torch.randn(64, 136, device=cuda)
    w, b = torch.randn(256, 136, device=cuda), torch.zeros(256, device=cuda)
    before = dict(swiglu.swiglu_cuda.launches_by_route)
    with pytest.raises(ValueError, match="multiple of 16"):
        swiglu.swiglu_cuda(x[:, :120], w[:, :120].contiguous(), b)  # E = 120
    with pytest.raises(ValueError, match="multiple of 64"):
        swiglu.swiglu_cuda(x[:, :128].contiguous(), w[:192, :128].contiguous(), b[:192])
    shifted = x.flatten()[4:4 + 64 * 128].view(64, 128)  # 16 bytes past an aligned base...
    with pytest.raises(ValueError, match="16-byte aligned"):
        swiglu.swiglu_cuda(x.flatten()[1:1 + 64 * 128].view(64, 128),
                           w[:, :128].contiguous(), b)
    swiglu.swiglu_cuda(shifted, w[:, :128].contiguous(), b)  # ...is taken
    assert swiglu.swiglu_cuda.launches_by_route[swiglu.TF32X3] == before[swiglu.TF32X3] + 1


def _tiny_eig(model_id: str, device, n_ev: int = 2, iters: int = 10):
    """get_eigenvectors on a tiny model built by the port's registry with
    seeded random weights, from a seeded xt, noise and v0, at a latent long
    enough that the attention (S >= 1024) goes to the kernel on a card:
    Stable Audio's rotary tables are set for 1024 latent frames. Returns
    the result and the launches of B1 and B3 it made."""
    from audioeditingcode_tpu_torch.editing.pc_drift import forward_directional, get_eigenvectors
    from audioeditingcode_tpu_torch.editing.solvers import as_solver
    from audioeditingcode_tpu_torch.models.registry import load_model
    from audioeditingcode_tpu_torch.models.text_encoders import repeat_cond

    pipe = load_model(model_id, 6, device=device, seed=0)
    if model_id == "test/tiny-stable-audio":
        pipe.sample_size = 1024
        pipe.setup_duration()
        shape, scale = (1, 4, 1024), 3.0
    else:
        shape, scale = (1, 4, 32, 32), 1.0
    g = torch.Generator().manual_seed(12)
    xt, z = (torch.randn(shape, generator=g) * s for s in (scale, 1.0))
    v0 = torch.randn((n_ev,) + shape[1:], generator=g)
    solver = as_solver(pipe.sched)
    hist = torch.randn(shape, generator=g)
    state = solver.init_state(xt.to(device), hist.to(device) if solver.carries_history else None)
    pair = pipe.make_eps_pair(repeat_cond(pipe.encode_text([""], negative=True), n_ev),
                              repeat_cond(pipe.encode_text(["a sine tone"]), n_ev))
    xe, ze = (t.repeat_interleave(n_ev, dim=0).to(device) for t in (xt, z))
    before = (fa.flash_attention_cuda.launches, swiglu.swiglu_cuda.launches)
    _, x0 = forward_directional(solver, pair, xe, 2, ze, 3.0, state=state)
    res = get_eigenvectors(solver, pair, xe, ze, torch.ones(shape, device=device), 2, x0,
                           v0=v0.to(device), const=0.1, iters=iters, cfg_tar=3.0, n_ev=n_ev,
                           state=state)
    return res, (fa.flash_attention_cuda.launches - before[0],
                 swiglu.swiglu_cuda.launches - before[1])


@pytest.mark.parametrize("model_id", ["test/tiny-audioldm", "test/tiny-stable-audio"])
def test_get_eigenvectors_card_matches_cpu(cuda, model_id):
    """Power iteration on the card (B1 at float32 on the 3xTF32 route)
    against the CPU's plain versions from the same v0, at
    the bounds of the CPU tests (tests/test_torch_pc_drift.py, c = 0.1):
    |cosine| >= 0.9999 with the same sign, eigenvalues 5e-4 relative,
    in_corrs 1e-3 absolute, in_norms 1e-4 relative."""
    got, (attn, ff) = _tiny_eig(model_id, cuda)
    want, _ = _tiny_eig(model_id, "cpu")
    iters, n_ev = 10, 2
    # one forward for x0 plus one per iteration, each launching B1 the same
    # number of times; the tiny DiT's width, 64, is under B3's E % 128 rule,
    # so its feed-forward takes the plain path on either device (as in JAX)
    assert attn >= iters + 1 and attn % (iters + 1) == 0, attn
    assert ff == 0
    a = got.eigvecs.double().cpu().reshape(n_ev, -1)
    b = want.eigvecs.double().reshape(n_ev, -1)
    cos = (a * b).sum(1) / a.norm(dim=1) / b.norm(dim=1)
    assert bool((cos >= 0.9999).all()), cos
    rel = ((got.eigvals.cpu() - want.eigvals).abs().max() / want.eigvals.abs().max()).item()
    assert rel <= 5e-4
    assert (got.in_corrs.cpu() - want.in_corrs).abs().max().item() <= 1e-3
    norm_rel = ((got.in_norms.cpu() - want.in_norms).abs().max()
                / want.in_norms.abs().max()).item()
    assert norm_rel <= 1e-4


# --- the window-batched edits (cli/run_long.py, cli/run_batch.py): N windows
# or clips folded into one CFG forward of 2N rows


@pytest.mark.parametrize("B,S,H,Hkv,D", [(6, 4096, 8, 8, 16), (6, 1024, 8, 8, 32),
                                         (4, 1025, 24, 12, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_at_the_window_batch(cuda, B, S, H, Hkv, D, dtype):
    """B1 at batch 2N: three AudioLDM-s windows (both UNet levels) and two
    Stable Audio windows, on the route of each dtype."""
    g = torch.Generator(device=cuda).manual_seed(11)
    q = torch.randn(B, S, H, D, device=cuda, generator=g).to(dtype)
    k = torch.randn(B, S, Hkv, D, device=cuda, generator=g).to(dtype)
    v = torch.randn(B, S, Hkv, D, device=cuda, generator=g).to(dtype)
    route = fa.attention_route(dtype)
    before = fa.flash_attention_cuda.launches_by_route[route]
    got = fa.flash_attention_cuda(q, k, v)
    torch.cuda.synchronize()
    assert fa.flash_attention_cuda.launches_by_route[route] == before + 1
    tol = fa.BF16_TOL if dtype == torch.bfloat16 else fa.F32_TOL
    torch.testing.assert_close(got.float(), fa.attention_reference(q, k, v).float(), **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_swiglu_at_the_window_batch(cuda, dtype):
    """B3 at M = 4100: the DiT feed-forward of two Stable Audio windows'
    CFG rows (2 x 2 x 1025 tokens), on the route of each dtype."""
    M, E, N = 4100, 1536, 6144
    g = torch.Generator(device=cuda).manual_seed(12)
    x = torch.randn(M, E, device=cuda, generator=g).to(dtype)
    w = (torch.randn(2 * N, E, device=cuda, generator=g) / E ** 0.5).to(dtype)
    b = torch.randn(2 * N, device=cuda, generator=g) * 0.1
    route = swiglu.swiglu_route(dtype)
    before = swiglu.swiglu_cuda.launches_by_route[route]
    got = swiglu.swiglu_cuda(x, w, b)
    torch.cuda.synchronize()
    assert swiglu.swiglu_cuda.launches_by_route[route] == before + 1
    tol = swiglu.BF16_TOL if dtype == torch.bfloat16 else swiglu.F32_TOL
    torch.testing.assert_close(got.float(), swiglu.swiglu_reference(x, w, b).float(), **tol)
