"""Head dims beside the ones the models use: every D <= 256 that the JAX
dispatcher sends to its Pallas kernel takes the port's kernel branch.

On the CPU that branch is the kernels' plain version; it is held against
the JAX dispatcher run as tests/test_flash_attention.py runs it (the
Pallas kernel in interpret mode), at 2e-5 in float32 (the sums run in
another order) and within ``fa.BF16_TOL`` in bfloat16. The zero-padding
that the tensor-core route applies to a head dim off a multiple of 8 is
held to the unpadded plain version. The kernels themselves run on the card
only (tests/test_torch_cuda.py)."""


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audioeditingcode_tpu.models.dit1d import rotary_tables as j_rotary_tables
from audioeditingcode_tpu.ops.flash_attention import fused_attention as j_fused
from audioeditingcode_tpu_torch.models.dit1d import rotary_tables
from audioeditingcode_tpu_torch.ops import flash_attention as fa

F32_TOL = {"atol": 2e-5, "rtol": 2e-5}


@pytest.fixture
def pallas_interpret(monkeypatch):
    """The JAX dispatcher's kernel branch on the CPU (its Pallas kernel in
    interpret mode), as its own tests run it."""
    monkeypatch.setenv("PALLAS_INTERPRET_ATTENTION", "1")


def _qkv(B, S, H, Hkv, D, dtype, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((B, S, h, D), dtype=np.float32) for h in (H, Hkv, Hkv)]
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return [jnp.asarray(x, jd) for x in arrs], [torch.from_numpy(x).to(td) for x in arrs]


@pytest.mark.parametrize("D", [20, 168, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dispatcher_matches_the_jax_kernel_branch(pallas_interpret, D, dtype):
    """A D off a multiple of 8, one between the f32 instances 160 and 192,
    and the widest: eligible at S = 1024, and equal to the JAX kernel."""
    (jq, jk, jv), (q, k, v) = _qkv(1, 1024, 2, 1, D, dtype, seed=D)
    assert fa.kernel_eligible(q, k)
    got = fa.fused_attention(q, k, v)
    torch.testing.assert_close(got, fa.attention_reference(q, k, v), rtol=0, atol=0)
    want = torch.from_numpy(np.asarray(j_fused(jq, jk, jv), np.float32))
    tol = fa.BF16_TOL if dtype == "bfloat16" else F32_TOL
    torch.testing.assert_close(got.float(), want, **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rotary_in_kernel_matches_the_jax_rotary_kernel(pallas_interpret, monkeypatch, dtype):
    """B2's branch at D = 200 with the DiT's rotary width 64."""
    monkeypatch.setenv("AEC_ROTARY_IN_KERNEL", "1")
    (jq, jk, jv), (q, k, v) = _qkv(1, 1025, 2, 1, 200, dtype, seed=200)
    jcos, jsin = j_rotary_tables(64, 1025)
    cos, sin = rotary_tables(64, 1025)
    np.testing.assert_array_equal(cos.numpy(), np.asarray(jcos))
    got = fa.fused_attention(q, k, v, rotary=(cos, sin))
    torch.testing.assert_close(got, fa.rotary_attention_reference(q, k, v, cos, sin),
                               rtol=0, atol=0)
    want = torch.from_numpy(np.asarray(j_fused(jq, jk, jv, rotary=(jcos, jsin)), np.float32))
    tol = fa.BF16_TOL if dtype == "bfloat16" else F32_TOL
    torch.testing.assert_close(got.float(), want, **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_zero_padded_head_dim_gives_the_unpadded_attention(dtype):
    """What the tensor-core route does with D = 20: q, k and v zero-padded
    to 24 features, the scale of the true D, the output sliced back."""
    g = torch.Generator().manual_seed(20)
    q, k, v = (torch.randn(1, 300, h, 20, generator=g).to(dtype) for h in (4, 2, 2))
    padded = fa.attention_reference(*(fa.pad_head_dim(x, 24) for x in (q, k, v)),
                                    scale=20 ** -0.5)
    assert padded.shape[-1] == 24 and not padded[..., 20:].any()
    torch.testing.assert_close(padded[..., :20], fa.attention_reference(q, k, v),
                               rtol=1e-6, atol=1e-6)
