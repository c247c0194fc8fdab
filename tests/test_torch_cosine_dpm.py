"""The port's cosine DPM-Solver++ numerics and solver against the JAX
functions on the same arrays. The schedule tables are computed in float64
numpy on both sides and must be bit-equal; the per-step float32 math
agrees to 1e-6 (relative and absolute); the inversion loops to 1e-5 over
12 steps, where the roundoff of each step carries into the next."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audioeditingcode_tpu.editing import invert as jinv
from audioeditingcode_tpu.editing.solvers import CosineDPMSolver as JSolver
from audioeditingcode_tpu.schedulers import cosine_dpm as jc
from audioeditingcode_tpu_torch.editing import invert as tinv
from audioeditingcode_tpu_torch.editing.solvers import CosineDPMSolver, as_solver
from audioeditingcode_tpu_torch.schedulers import cosine_dpm as tc
from test_torch_helpers import to_np

CONFIGS = {
    "stable_audio": {},
    "karras_sigma_min": dict(sigma_schedule="karras", final_sigmas_type="sigma_min"),
    "epsilon_order1": dict(prediction_type="epsilon", solver_order=1, sigma_data=0.5),
}
SHAPE = (1, 4, 16)


def _pair(name, steps=12):
    kw = CONFIGS[name]
    return (jc.make_cosine_dpm_schedule(jc.CosineDPMConfig(**kw), steps),
            tc.make_cosine_dpm_schedule(tc.CosineDPMConfig(**kw), steps))


def _arrays(n, shape=SHAPE, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, dtype=np.float32) for _ in range(n)]


def _close(got, want, tol=1e-6):
    np.testing.assert_allclose(to_np(got), np.asarray(want, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("steps", [6, 12, 100])
def test_schedule_tables_bit_equal(name, steps):
    js, ts = _pair(name, steps)
    for f in ("sigmas", "timesteps", "step_first_order", "step_zero_noise"):
        a, b = np.asarray(getattr(js, f)), np.asarray(getattr(ts, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert np.array_equal(ts.sigmas_host, ts.sigmas.numpy())


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("k", [0, 1, 6, 11])
@pytest.mark.parametrize("warm", [False, True])
def test_step_functions(name, k, warm):
    """scale_model_input, convert_model_output, solver_step and recover_noise
    (with and without numerical_fix), from a cold and a warm state; k = 11
    is the final, zero-sigma step."""
    js, ts = _pair(name)
    x, out, xtm1, noise, m1 = _arrays(5, seed=k)
    J = [jnp.asarray(a) for a in (x, out, xtm1, noise, m1)]
    T = [torch.from_numpy(a) for a in (x, out, xtm1, noise, m1)]
    jst = jc.init_solver_state(J[0], J[4] if warm else None)
    tst = tc.init_solver_state(T[0], T[4] if warm else None)
    _close(tc.scale_model_input(ts, k, T[0]), jc.scale_model_input(js, k, J[0]))
    _close(tc.convert_model_output(ts, k, T[0], T[1]), jc.convert_model_output(js, k, J[0], J[1]))
    jnew, jprev = jc.solver_step(js, jst, k, J[1], J[0], J[3])
    tnew, tprev = tc.solver_step(ts, tst, k, T[1], T[0], T[3])
    _close(tprev, jprev)
    _close(tnew.m1, jnew.m1)
    assert tnew.m1_valid and bool(jnew.m1_valid)
    for fix in (True, False):
        want = jc.recover_noise(js, jst, k, J[0], J[2], J[1], numerical_fix=fix)
        got = tc.recover_noise(ts, tst, k, T[0], T[2], T[1], numerical_fix=fix)
        for g, w in zip(got[1:], want[1:]):
            _close(g, w, tol=2e-6)


def test_recover_noise_inverts_solver_step():
    """z recovered from a solver step's output reproduces that output."""
    _, ts = _pair("stable_audio")
    x, out, noise, m1 = (torch.from_numpy(a) for a in _arrays(4, seed=3))
    st = tc.init_solver_state(x, m1)
    _, prev = tc.solver_step(ts, st, 4, out, x, noise)
    _, z, fixed, extra = tc.recover_noise(ts, st, 4, x, prev, out)
    torch.testing.assert_close(z, noise, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(fixed, prev, rtol=1e-6, atol=1e-6)
    assert extra is m1


def test_state_is_promoted_float32():
    """A bf16 latent gets a float32 history, as the JAX package's 18a9e89."""
    like = torch.zeros(SHAPE, dtype=torch.bfloat16)
    st = tc.init_solver_state(like)
    assert st.m1.dtype == torch.float32 and not st.m1_valid
    warm = tc.init_solver_state(like, torch.ones(SHAPE, dtype=torch.bfloat16))
    assert warm.m1.dtype == torch.float32 and warm.m1_valid
    _, ts = _pair("stable_audio")
    x = torch.randn(SHAPE).to(torch.bfloat16)
    assert tc.scale_model_input(ts, 2, x).dtype == torch.float32
    _, prev = tc.solver_step(ts, st, 2, x, x, x)
    assert prev.dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sample_xts_with_passed_noise(dtype):
    js, ts = _pair("stable_audio")
    (x0,) = _arrays(1)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    rng = jax.random.PRNGKey(3)
    jx0 = jnp.asarray(x0, jd)
    want = jc.sample_xts_from_x0_sigma(js, jx0, rng)
    # the JAX draw (in x0's dtype), passed in: torch cannot reproduce jax.random
    noise = np.asarray(jax.random.normal(rng, (12,) + SHAPE, dtype=jd), np.float32)
    tx0 = torch.from_numpy(np.array(jx0, np.float32)).to(getattr(torch, dtype))
    got = tc.sample_xts_from_x0_sigma(ts, tx0, torch.from_numpy(noise).to(tx0.dtype))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    _close(got, want)
    drawn = tc.sample_xts_from_x0_sigma(ts, tx0, torch.Generator().manual_seed(0))
    assert drawn.shape == got.shape and torch.equal(drawn[0], tx0.float())


def _denoisers():
    """The same smooth nonlinear 'model' on both sides."""
    w = np.random.default_rng(7).standard_normal((4, 4)).astype(np.float32) / 2

    def jden(x, k):
        return jnp.tanh(jnp.einsum("ij,bjl->bil", jnp.asarray(w), x)) * (1.0 + 0.05 * k)

    def tden(x, k):
        return torch.tanh(torch.einsum("ij,bjl->bil", torch.from_numpy(w), x)) * (1.0 + 0.05 * k)

    return jden, tden


@pytest.mark.parametrize("first_order", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_inversion_and_warm_start_reverse(first_order, dtype):
    """The forward pass (zs, xts, extras) and the reverse pass warm-started
    with extras[T - 1], for the 2nd-order solver and with first_order, from
    a float32 and a bfloat16 latent."""
    js, ts = _pair("stable_audio")
    jsol, tsol = JSolver(js), CosineDPMSolver(ts)
    if first_order:
        jsol, tsol = jsol.replace(first_order=True), dataclasses.replace(tsol, first_order=True)
    assert as_solver(tsol) is tsol and isinstance(as_solver(ts), CosineDPMSolver)
    jden, tden = _denoisers()
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    (x0,) = _arrays(1, seed=11)
    jx0 = jnp.asarray(x0, jd)
    rng = jax.random.PRNGKey(5)
    noise = np.asarray(jax.random.normal(rng, (12,) + SHAPE, dtype=jd), np.float32)
    tx0 = torch.from_numpy(np.array(jx0, np.float32)).to(getattr(torch, dtype))
    _, jzs, jxts, jext = jinv.inversion_forward_process(jsol, jden, jx0, rng, return_extras=True)
    _, tzs, txts, text = tinv.inversion_forward_process(
        tsol, tden, tx0, torch.from_numpy(noise).to(tx0.dtype), return_extras=True)
    assert txts.dtype == tzs.dtype == text.dtype == torch.float32
    for g, w in ((tzs, jzs), (txts, jxts), (text, jext)):
        _close(g, w, tol=1e-5)
    T = 8
    want = jinv.inversion_reverse_process(jsol, jden, jxts, jzs[:T], init_history=jext[T - 1])
    got = tinv.inversion_reverse_process(tsol, tden, txts, tzs[:T], init_history=text[T - 1])
    _close(got, want, tol=1e-5)
    cold = tinv.inversion_reverse_process(tsol, tden, txts, tzs[:T])
    assert not torch.allclose(cold, got, rtol=1e-4, atol=1e-4) or first_order


def test_full_round_trip_reconstructs_x0():
    """Inversion then a full reverse pass with zs[0] kept reproduces the
    recorded trajectory start."""
    _, ts = _pair("stable_audio")
    _, tden = _denoisers()
    x0 = torch.from_numpy(_arrays(1, seed=12)[0])
    _, zs, xts, ext = tinv.inversion_forward_process(
        ts, tden, x0, torch.Generator().manual_seed(1), zero_first=False, return_extras=True)
    rec = tinv.inversion_reverse_process(ts, tden, xts, zs, init_history=ext[-1])
    torch.testing.assert_close(rec, xts[0], rtol=1e-4, atol=1e-4)
