"""The port's fused SwiGLU: the kernel's plain version against the Pallas
kernel (interpret mode) on the tests/test_swiglu.py shapes, and the
dispatcher's routing.

Tolerances: 2e-5 in float32 (as tests/test_swiglu.py: the sums run in
another order), 3e-2 in bfloat16. In bfloat16 the plain version follows
the Pallas kernel's rounding (bias added in f32, SiLU in f32, one cast), so
it is held against ``_swiglu_call(interpret=True)``, not against JAX's
``_reference``, which adds the bias in the input dtype. The bounds the card
holds the kernels to, ``swiglu.F32_TOL`` and ``swiglu.BF16_TOL``, are
pinned here: what the float32 kernel's tensor-core arithmetic passes and
what a broken kernel fails."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audioeditingcode_tpu.ops.swiglu import _reference, _swiglu_call
from audioeditingcode_tpu.ops.swiglu import fused_swiglu as j_fused_swiglu
from audioeditingcode_tpu_torch.ops import swiglu
from test_torch_helpers import tf32_round, tf32_split, to_np


def _inputs(m, e, n, dtype, seed=0):
    """x (M, E), the JAX kernel (E, 2N) and its torch Linear weight (2N, E),
    and a float32 bias (2N,), from numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, e), dtype=np.float32)
    kernel = rng.standard_normal((e, 2 * n), dtype=np.float32) / np.sqrt(e)
    bias = rng.standard_normal(2 * n, dtype=np.float32) * 0.1
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jax_in = (jnp.asarray(x, jd), jnp.asarray(kernel, jd), jnp.asarray(bias))
    torch_in = (torch.from_numpy(x).to(td), torch.from_numpy(kernel.T.copy()).to(td),
                torch.from_numpy(bias))
    return jax_in, torch_in


@pytest.mark.parametrize("m,e,n", [(512, 128, 256), (520, 256, 512), (2066, 128, 384)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_matches_pallas_kernel(m, e, n, dtype):
    (jx, jk, jb), (tx, tw, tb) = _inputs(m, e, n, dtype)
    want = np.asarray(_swiglu_call(jx, jk, jb, interpret=True), np.float32)
    got = swiglu.swiglu_reference(tx, tw, tb)
    assert got.dtype == tx.dtype and got.shape == (m, n)
    tol = 3e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(to_np(got), want, atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dispatcher_takes_kernel_branch(dtype, monkeypatch):
    """E = N = 128 at 512 rows is eligible: on a CPU tensor that branch is
    the plain version, and it matches the JAX dispatcher's Pallas branch."""
    monkeypatch.setenv("PALLAS_INTERPRET_SWIGLU", "1")
    (jx, jk, jb), (tx, tw, tb) = _inputs(512, 128, 128, dtype, seed=1)
    assert swiglu.kernel_eligible(tx, tw)
    calls = []
    ref = swiglu.swiglu_reference
    monkeypatch.setattr(swiglu, "swiglu_reference", lambda *a: calls.append(1) or ref(*a))
    got = swiglu.fused_swiglu(tx.reshape(2, 256, 128), tw, tb)
    assert calls == [1] and got.shape == (2, 256, 128)
    want = np.asarray(j_fused_swiglu(jx.reshape(2, 256, 128), jk, jb), np.float32)
    tol = 3e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(to_np(got), want, atol=tol, rtol=tol)


@pytest.mark.parametrize("m,e,n,env", [(256, 128, 128, "1"), (512, 96, 128, "1"),
                                       (512, 128, 128, "0")])
def test_dispatcher_plain_path_matches_jax_reference(m, e, n, env, monkeypatch):
    """Too few rows, an unaligned width or the AEC_FUSED_SWIGLU=0 kill switch
    take JAX's _reference expression."""
    monkeypatch.setenv("AEC_FUSED_SWIGLU", env)
    (jx, jk, jb), (tx, tw, tb) = _inputs(m, e, n, "float32", seed=2)
    assert not swiglu.kernel_eligible(tx, tw)
    want = _reference(jx, jk, jb)
    np.testing.assert_allclose(to_np(swiglu.fused_swiglu(tx, tw, tb)), np.asarray(want),
                               atol=2e-5, rtol=2e-5)


def test_cuda_wrapper_rejects_cpu_tensors():
    _, (tx, tw, tb) = _inputs(512, 128, 128, "float32")
    before = swiglu.swiglu_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        swiglu.swiglu_cuda(tx, tw, tb)
    assert swiglu.swiglu_cuda.launches == before


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, swiglu.TENSOR_CORE),
                                         (torch.float32, swiglu.TF32X3)])
def test_swiglu_route(dtype, route):
    """bfloat16 goes to the bf16 tensor-core kernel, float32 to the 3xTF32
    one."""
    assert swiglu.swiglu_route(dtype) == route


def _round_toward_zero(x: torch.Tensor) -> torch.Tensor:
    """float64 to float32, rounded toward zero, as the tensor cores round
    each sum they add into an accumulator."""
    r = x.to(torch.float32)
    return torch.where(r.double().abs() > x.abs(), torch.nextafter(r, torch.zeros_like(r)), r)


def _tensor_core_swiglu(x, w, b, chain, three=True):
    """The float32 kernel's arithmetic (csrc/swiglu.cu) emulated: per k8 step
    the products lo_x hi_w, hi_x lo_w and hi_x hi_w of the TF32 parts
    (``three=False``: one TF32 product), each step's sum added into the
    accumulator with truncation; a fresh accumulator every ``chain``
    features, added into the running f32 sum with rounded adds; then the f32
    epilogue."""
    if three:
        (xh, xl), (wh, wl) = tf32_split(x), tf32_split(w)
        terms = [(xl, wh), (xh, wl), (xh, wh)]
    else:
        terms = [(tf32_round(x), tf32_round(w))]
    terms = [(a.double(), c.double()) for a, c in terms]
    h = torch.zeros(x.shape[0], w.shape[0])
    for c0 in range(0, x.shape[1], chain):
        acc = torch.zeros(x.shape[0], w.shape[0], dtype=torch.float64)
        for k in range(c0, min(c0 + chain, x.shape[1]), 8):
            for a, c in terms:
                acc = _round_toward_zero(acc + a[:, k:k + 8] @ c[:, k:k + 8].T).double()
        h = h + acc.float()
    n = w.shape[0] // 2
    a, g = h[:, :n] + b[:n], h[:, n:] + b[n:]
    return a * (g * torch.sigmoid(g))


@pytest.mark.parametrize("chain,three,passes", [
    (32, True, True),     # the kernel: a fresh stage accumulator every BK = 32 features
    (64, True, True),
    (32, False, False),   # one TF32 product: about 90x the bound
    (1536, True, False),  # one truncating chain over all of E: about 3x the bound
])
def test_f32_tolerance_pins_the_tensor_core_arithmetic(chain, three, passes):
    """swiglu.F32_TOL, the bound the card holds the float32 kernel to, at the
    DiT's E = 1536: 3xTF32 with fresh accumulators every 32 or 64 features
    passes (about 0.15 of it), while one TF32 product, or one truncating
    chain over all of E, fails, so a card check sees a kernel that lost its
    lo terms or its per-stage sums."""
    _, (x, w, b) = _inputs(16, 1536, 32, "float32", seed=3)
    got = _tensor_core_swiglu(x, w, b, chain, three)
    want = swiglu.swiglu_reference(x, w, b)
    if passes:
        torch.testing.assert_close(got, want, **swiglu.F32_TOL)
    else:
        with pytest.raises(AssertionError, match="Tensor-likes are not close"):
            torch.testing.assert_close(got, want, **swiglu.F32_TOL)


def test_bf16_tolerance_passes_the_pallas_kernel():
    """The Pallas kernel (interpret mode) in bfloat16 at E = 1536 lies within
    swiglu.BF16_TOL (two bf16 ulps) of the plain version."""
    (jx, jk, jb), (tx, tw, tb) = _inputs(64, 1536, 128, "bfloat16", seed=4)
    want = torch.from_numpy(np.asarray(_swiglu_call(jx, jk, jb, interpret=True), np.float32))
    torch.testing.assert_close(swiglu.swiglu_reference(tx, tw, tb).float(), want,
                               **swiglu.BF16_TOL)


@pytest.mark.parametrize("mutant", ["last_slice_skipped", "value_gate_swapped"])
def test_bf16_tolerance_rejects_a_broken_kernel(mutant):
    """What a bf16 kernel that skipped its last 64-feature slice of E, or
    swapped the value and gate halves, returns lies outside swiglu.BF16_TOL
    of the Pallas kernel."""
    (jx, jk, jb), (tx, tw, tb) = _inputs(64, 1536, 128, "bfloat16", seed=4)
    want = torch.from_numpy(np.asarray(_swiglu_call(jx, jk, jb, interpret=True), np.float32))
    if mutant == "last_slice_skipped":
        tx = tx.clone()
        tx[:, -64:] = 0
    else:
        tw, tb = (torch.cat(t.chunk(2)[::-1]) for t in (tw, tb))
    with pytest.raises(AssertionError, match="Tensor-likes are not close"):
        torch.testing.assert_close(swiglu.swiglu_reference(tx, tw, tb).float(), want,
                                   **swiglu.BF16_TOL)


def test_swiglu_route_rejects_other_dtypes():
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        swiglu.swiglu_route(torch.float16)
