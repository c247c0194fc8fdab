"""The port's fused SwiGLU: the kernel's plain version against the Pallas
kernel (interpret mode) on the tests/test_swiglu.py shapes, and the
dispatcher's routing.

Tolerances: 2e-5 in float32 (as tests/test_swiglu.py: the sums run in
another order), 3e-2 in bfloat16. In bfloat16 the plain version follows
the Pallas kernel's rounding (bias added in f32, SiLU in f32, one cast), so
it is held against ``_swiglu_call(interpret=True)``, not against JAX's
``_reference``, which adds the bias in the input dtype."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audioeditingcode_tpu.ops.swiglu import _reference, _swiglu_call
from audioeditingcode_tpu.ops.swiglu import fused_swiglu as j_fused_swiglu
from audioeditingcode_tpu_torch.ops import swiglu
from test_torch_helpers import to_np


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
                                         (torch.float32, swiglu.CUDA_CORE)])
def test_swiglu_route(dtype, route):
    """bfloat16 goes to the tensor-core kernel, float32 to the CUDA-core one."""
    assert swiglu.swiglu_route(dtype) == route


def test_swiglu_route_rejects_other_dtypes():
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        swiglu.swiglu_route(torch.float16)
