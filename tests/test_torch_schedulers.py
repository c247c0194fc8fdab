"""The port's DDIM numerics, solver, CFG tensors and gaussian blur against
the JAX functions on the same arrays. The schedule tables are computed in
float64 numpy on both sides and must be bit-equal; per-step float32 math
agrees to about 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audioeditingcode_tpu.editing import cfg as jcfg
from audioeditingcode_tpu.editing.solvers import DDIMSolver as JDDIMSolver
from audioeditingcode_tpu.ops.filters import gaussian_blur_2d as j_blur
from audioeditingcode_tpu.schedulers import ddim as jd
from audioeditingcode_tpu_torch.editing import cfg as tcfg
from audioeditingcode_tpu_torch.editing.solvers import DDIMSolver, as_solver
from audioeditingcode_tpu_torch.ops.filters import gaussian_blur_2d
from audioeditingcode_tpu_torch.schedulers import ddim as td
from test_torch_helpers import to_np

CONFIGS = {
    "audioldm": td.DDIMConfig(),
    "v_linspace": td.DDIMConfig(prediction_type="v_prediction", beta_schedule="linear",
                                timestep_spacing="linspace"),
    "cos_trailing": td.DDIMConfig(beta_schedule="squaredcos_cap_v2",
                                  timestep_spacing="trailing", set_alpha_to_one=True),
}


def _pair(name, steps=50):
    cfg = CONFIGS[name]
    jcfg_ = jd.DDIMConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    return jd.make_schedule(jcfg_, steps), td.make_schedule(cfg, steps)


def _arrays(n, shape=(1, 4, 8, 6), seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, dtype=np.float32) for _ in range(n)]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_schedule_tables_bit_equal(name):
    js, ts = _pair(name)
    for f in ("alphas_cumprod", "timesteps", "step_alpha_prod", "step_alpha_prod_prev",
              "step_variance"):
        a, b = np.asarray(getattr(js, f)), getattr(ts, f).numpy()
        assert np.array_equal(a, b.astype(a.dtype)), f
    np.testing.assert_array_equal(jd.make_betas(jd.DDIMConfig()), td.make_betas(td.DDIMConfig()))


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("k", [0, 17, 49])
def test_step_functions(name, k):
    js, ts = _pair(name)
    x, out, xtm1, noise = _arrays(4, seed=k)
    J = [jnp.asarray(a) for a in (x, out, xtm1, noise)]
    T = [torch.from_numpy(a) for a in (x, out, xtm1, noise)]
    pairs = [
        (jd.pred_original_sample(js, k, J[0], J[1]), td.pred_original_sample(ts, k, T[0], T[1])),
        (jd.pred_epsilon(js, k, J[0], J[1]), td.pred_epsilon(ts, k, T[0], T[1])),
        (jd.get_variance(js, k), td.get_variance(ts, k)),
        (jd.add_noise(js, J[0], J[3], 500), td.add_noise(ts, T[0], T[3], 500)),
        (jd.reverse_step_with_custom_noise(js, k, J[1], J[0], J[3], eta=1.0),
         td.reverse_step_with_custom_noise(ts, k, T[1], T[0], T[3], eta=1.0)),
        (jd.reverse_step_with_custom_noise(js, k, J[1], J[0]),
         td.reverse_step_with_custom_noise(ts, k, T[1], T[0])),
    ]
    for fix in (True, False):
        pairs += list(zip(jd.get_zs_from_xts(js, k, J[0], J[2], J[1], numerical_fix=fix),
                          td.get_zs_from_xts(ts, k, T[0], T[2], T[1], numerical_fix=fix)))
    for want, got in pairs:
        np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_sample_xts_with_passed_noise():
    js, ts = _pair("audioldm", steps=20)
    (x0,) = _arrays(1)
    rng = jax.random.PRNGKey(3)
    want = jd.sample_xts_from_x0(js, jnp.asarray(x0), rng)
    # the JAX draw, passed in: torch cannot reproduce jax.random
    noise = np.array(jax.random.normal(rng, (20,) + x0.shape, dtype=jnp.float32))
    got = td.sample_xts_from_x0(ts, torch.from_numpy(x0), torch.from_numpy(noise))
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-6, atol=1e-6)
    drawn = td.sample_xts_from_x0(ts, torch.from_numpy(x0), torch.Generator().manual_seed(0))
    assert drawn.shape == got.shape and torch.equal(drawn[0], torch.from_numpy(x0))


def test_ddim_solver_matches():
    js, ts = _pair("audioldm", steps=20)
    jsol, tsol = JDDIMSolver(js), as_solver(ts)
    assert isinstance(tsol, DDIMSolver) and as_solver(tsol) is tsol
    x, xtm1, out, z = _arrays(4, seed=9)
    J = [jnp.asarray(a) for a in (x, xtm1, out, z)]
    T = [torch.from_numpy(a) for a in (x, xtm1, out, z)]
    _, jz, jfix, _ = jsol.forward_step((), 5, J[0], J[1], J[2])
    _, tz, tfix, _ = tsol.forward_step((), 5, T[0], T[1], T[2])
    _, jrev = jsol.reverse_step((), 5, J[0], J[2], J[3])
    _, trev = tsol.reverse_step((), 5, T[0], T[2], T[3])
    for want, got in ((jz, tz), (jfix, tfix), (jrev, trev)):
        np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-6, atol=1e-6)
    assert tsol.init_state(T[0]) == ()


@pytest.mark.parametrize("shape", [(2, 4, 30, 8), (3, 17, 9)])
def test_gaussian_blur(shape):
    (x,) = _arrays(1, shape=shape, seed=5)
    want = j_blur(jnp.asarray(x), 15, 1.0)
    np.testing.assert_allclose(to_np(gaussian_blur_2d(torch.from_numpy(x), 15, 1.0)),
                               np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("prompts,scales,cutoffs,zero_empty", [
    (["a trumpet"], [12.0], None, False),
    ([""], [3.0], None, True),
    (["a trumpet", "a violin"], [12.0, 6.0], None, False),
    (["", "a violin", "drums"], [3.0], [0.25, 0.6], True),
])
def test_build_cfg_tensors(prompts, scales, cutoffs, zero_empty):
    shape = (1, 8, 64, 16)
    jc, jm = jcfg.build_cfg_tensors(shape, prompts, scales, cutoff_points=cutoffs,
                                    zero_empty_prompts=zero_empty)
    tc, tm = tcfg.build_cfg_tensors(shape, prompts, scales, cutoff_points=cutoffs,
                                    zero_empty_prompts=zero_empty)
    assert tuple(tc.shape) == (len(prompts),) + shape[1:]
    np.testing.assert_allclose(to_np(tc), np.asarray(jc), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(to_np(tm), np.asarray(jm), rtol=1e-6, atol=1e-6)
