"""The posterior-PC modules of the port against the JAX package, module by
module, on test/tiny-audioldm (DDIM) and test/tiny-stable-audio (cosine DPM
solver, with a warm solver history): the same numpy inputs, the same params
(bridged), and the JAX draws passed to the port.

Tolerances (max abs error over max abs value unless said otherwise):
- scheduler and solver step math: 1e-6 (float32 elementwise math in another
  order);
- forward_directional and apply_drift, one guided denoiser step: 1e-4
  (whole float32 module forwards, as the other port tests);
- get_eigenvectors: the finite-difference probe x0(xt + c v) - x0(xt)
  divides float32 roundoff of x0 by c. At the CLI's c = 1e-3 the probe of
  a tiny random model is ~2e-5 per element against ~1e-6 of roundoff, and
  21 iterations turn two float32 implementations' roundoff into eigenvectors
  at |cosine| 0.84-0.92 (measured; 0.997-0.999 at c = 1e-2). So the
  iteration is held to JAX at c = 0.1, where the probe sits far above
  roundoff: |cosine| >= 0.9999 with the same sign for the eigenvectors and
  the snapshot (measured >= 0.99999), eigenvalues 5e-4 relative (measured
  <= 1.2e-4), in_corrs 1e-3 (<= 3.6e-4) and in_norms 1e-4 (<= 2.3e-5); and
  the probe itself at c = 1e-3, one iteration: |cosine| >= 0.9999 (>=
  0.99998) and in_norms 1e-3 relative (<= 6.8e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audioeditingcode_tpu.editing import pc_drift as jpc
from audioeditingcode_tpu.editing.solvers import as_solver as j_as_solver
from audioeditingcode_tpu.models.text_encoders import repeat_cond as j_repeat
from audioeditingcode_tpu.schedulers import cosine_dpm as jcos
from audioeditingcode_tpu.schedulers import ddim as jddim
from audioeditingcode_tpu_torch.editing import pc_drift as tpc
from audioeditingcode_tpu_torch.editing.solvers import as_solver as t_as_solver
from audioeditingcode_tpu_torch.models.text_encoders import repeat_cond as t_repeat
from audioeditingcode_tpu_torch.schedulers import cosine_dpm as tcos
from audioeditingcode_tpu_torch.schedulers import ddim as tddim
from test_torch_helpers import (
    jax_tiny_pipeline,
    jax_tiny_stable_audio,
    port_tiny_pipeline,
    port_tiny_stable_audio,
    rel_err,
    to_np,
)

STEPS = 6
STEP_TOL = 1e-6
MODULE_TOL = 1e-4
MODELS = ["audioldm", "stable_audio"]
# latents small enough that no attention reaches the S >= 1024 kernel path
SHAPES = {"audioldm": (1, 4, 16, 32), "stable_audio": (1, 4, 16)}
K = 2  # the step position of every case (mid-trajectory: a warm solver history)


@pytest.fixture(scope="module")
def pipes():
    jal = jax_tiny_pipeline(STEPS)
    jsa = jax_tiny_stable_audio(STEPS)
    return {"audioldm": (jal, port_tiny_pipeline(STEPS, jal)),
            "stable_audio": (jsa, port_tiny_stable_audio(STEPS, jsa))}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _case(pipes, model, n=1, seed=0):
    """Inputs of one case on both sides: xt, z and a solver state at step K,
    and CFG pairs of batch n."""
    jp, tp = pipes[model]
    rng = np.random.default_rng(seed)
    shape = SHAPES[model]
    xt = rng.standard_normal(shape).astype(np.float32)
    z = rng.standard_normal(shape).astype(np.float32)
    if model == "stable_audio":
        xt *= 3.0  # around sigma at step K of the tiny schedule
        hist = rng.standard_normal(shape).astype(np.float32)
        jst = jcos.init_solver_state(jnp.asarray(xt), jnp.asarray(hist))
        tst = tcos.init_solver_state(_t(xt), _t(hist))
    else:
        jst, tst = (), ()
    ju, jc = jp.encode_text([""], negative=True), jp.encode_text(["a sine tone"])
    tu, tc = tp.encode_text([""], negative=True), tp.encode_text(["a sine tone"])
    return dict(
        xt=xt, z=z, jst=jst, tst=tst,
        jpair=jp.make_eps_pair(j_repeat(ju, n), j_repeat(jc, n)),
        tpair=tp.make_eps_pair(t_repeat(tu, n), t_repeat(tc, n)),
        jsolver=j_as_solver(jp.sched), tsolver=t_as_solver(tp.sched))


@pytest.mark.parametrize("eta", [0.0, 1.0])
def test_get_sigma_and_ddim_step(eta):
    config = jddim.DDIMConfig()
    jsched = jddim.make_schedule(config, STEPS)
    tsched = tddim.make_schedule(tddim.DDIMConfig(), STEPS)
    rng = np.random.default_rng(1)
    for k in range(STEPS):
        assert rel_err(to_np(tddim.get_sigma(tsched, k)), np.asarray(jddim.get_sigma(jsched, k))) \
            <= STEP_TOL
        out, x, noise = (rng.standard_normal((1, 4, 8, 8)).astype(np.float32) for _ in range(3))
        for vn in (None, noise):
            jprev, jx0 = jddim.ddim_step(jsched, k, jnp.asarray(out), jnp.asarray(x), eta=eta,
                                         variance_noise=None if vn is None else jnp.asarray(vn))
            tprev, tx0 = tddim.ddim_step(tsched, k, _t(out), _t(x), eta=eta,
                                         variance_noise=None if vn is None else _t(vn))
            assert rel_err(to_np(tprev), np.asarray(jprev)) <= STEP_TOL
            assert rel_err(to_np(tx0), np.asarray(jx0)) <= STEP_TOL


@pytest.mark.parametrize("shifted", [True, False])
@pytest.mark.parametrize("model", MODELS)
def test_solver_pc_surface(pipes, model, shifted):
    """x0_shift_coeff, directional_step and drift_step of each solver."""
    c = _case(pipes, model, seed=2)
    js, ts = c["jsolver"], c["tsolver"]
    for k in range(STEPS):
        assert rel_err(to_np(ts.x0_shift_coeff(k)), np.asarray(js.x0_shift_coeff(k))) <= STEP_TOL
    rng = np.random.default_rng(3)
    out, shift = (rng.standard_normal(c["xt"].shape).astype(np.float32) for _ in range(2))
    jst, jprev, jx0 = js.directional_step(c["jst"], K, jnp.asarray(c["xt"]), jnp.asarray(out),
                                          jnp.asarray(c["z"]))
    tst, tprev, tx0 = ts.directional_step(c["tst"], K, _t(c["xt"]), _t(out), _t(c["z"]))
    assert rel_err(to_np(tprev), np.asarray(jprev)) <= STEP_TOL
    assert rel_err(to_np(tx0), np.asarray(jx0)) <= STEP_TOL
    _, jdrift = js.drift_step(c["jst"], K, jnp.asarray(c["xt"]), jprev, jx0,
                              0.1 * jnp.asarray(shift), jnp.asarray(c["z"]),
                              use_shifted_x0_for_noisepred=shifted)
    _, tdrift = ts.drift_step(c["tst"], K, _t(c["xt"]), _t(jprev), _t(jx0), 0.1 * _t(shift),
                              _t(c["z"]), use_shifted_x0_for_noisepred=shifted)
    assert rel_err(to_np(tdrift), np.asarray(jdrift)) <= STEP_TOL
    if model == "stable_audio":  # the history each step hands on
        assert rel_err(to_np(tst.m1), np.asarray(jst.m1)) <= STEP_TOL


@pytest.mark.parametrize("mode", list(tpc.PCStreamChoice), ids=lambda m: m.name)
@pytest.mark.parametrize("model", MODELS)
def test_forward_directional(pipes, model, mode):
    c = _case(pipes, model, seed=4)
    v = 0.05 * np.random.default_rng(5).standard_normal(c["xt"].shape).astype(np.float32)
    jmode = jpc.PCStreamChoice[mode.name]
    jprev, jx0, jst = jpc.forward_directional(
        c["jsolver"], c["jpair"], jnp.asarray(c["xt"]), K, jnp.asarray(c["z"]), 3.0,
        eigvecs=jnp.asarray(v), amount=1.5, mode=jmode, state=c["jst"], return_state=True)
    tprev, tx0, tst = tpc.forward_directional(
        c["tsolver"], c["tpair"], _t(c["xt"]), K, _t(c["z"]), 3.0, eigvecs=_t(v), amount=1.5,
        mode=mode, state=c["tst"], return_state=True)
    assert rel_err(to_np(tprev), np.asarray(jprev)) <= MODULE_TOL
    assert rel_err(to_np(tx0), np.asarray(jx0)) <= MODULE_TOL
    if model == "stable_audio":
        assert rel_err(to_np(tst.m1), np.asarray(jst.m1)) <= MODULE_TOL


def _eig_pair(pipes, model, n_ev, const, iters, seed, patch=False):
    """get_eigenvectors through JAX (its key) and through the port (the
    key's draw as v0), from the same unperturbed x0 prediction; with
    ``patch``, a time-axis patch mask."""
    c = _case(pipes, model, n=n_ev, seed=seed)
    shape = c["xt"].shape
    mask = np.ones(shape, np.float32)
    if patch:
        mask[...] = 0
        mask[:, :, 2:12] = 1
    xe, ze = np.repeat(c["xt"], n_ev, 0), np.repeat(c["z"], n_ev, 0)
    _, jx0 = jpc.forward_directional(c["jsolver"], c["jpair"], jnp.asarray(xe), K,
                                     jnp.asarray(ze), 3.0, state=c["jst"])
    key = jax.random.PRNGKey(seed)
    v0 = _t(jax.random.normal(key, xe.shape))
    common = dict(n_ev=n_ev, iters=iters, cfg_tar=3.0, const=const)
    jr = jpc.get_eigenvectors(c["jsolver"], c["jpair"], jnp.asarray(xe), jnp.asarray(ze),
                              jnp.asarray(mask), jnp.asarray(K), jx0, key, state=c["jst"],
                              **common)
    tr = tpc.get_eigenvectors(c["tsolver"], c["tpair"], _t(xe), _t(ze), _t(mask), K, _t(jx0),
                              v0=v0, state=c["tst"], **common)
    return jr, tr


def _cosines(got, ref, n_ev):
    a, b = to_np(got).reshape(n_ev, -1), np.asarray(ref).reshape(n_ev, -1)
    return (a * b).sum(1) / np.linalg.norm(a, axis=1) / np.linalg.norm(b, axis=1)


@pytest.mark.parametrize("n_ev,patch", [(1, False), (1, True), (2, False)])
@pytest.mark.parametrize("model", MODELS)
def test_get_eigenvectors(pipes, model, n_ev, patch):
    """21 iterations (a snapshot at 20) at c = 0.1 (module docstring)."""
    jr, tr = _eig_pair(pipes, model, n_ev, const=0.1, iters=21, seed=6, patch=patch)
    assert tr.snapshot_iters == jr.snapshot_iters == (20,)
    cos = _cosines(tr.eigvecs, jr.eigvecs, n_ev)
    snap_cos = _cosines(tr.interm_eigvecs[0], jr.interm_eigvecs[0], n_ev)
    errs = {f: rel_err(to_np(getattr(tr, f)), np.asarray(getattr(jr, f)))
            for f in ("eigvals", "in_corrs", "in_norms", "interm_eigvals")}
    assert np.all(cos >= 0.9999) and np.all(snap_cos >= 0.9999), (cos, snap_cos)  # same sign
    assert max(errs["eigvals"], errs["interm_eigvals"]) <= 5e-4, errs
    assert errs["in_corrs"] <= 1e-3 and errs["in_norms"] <= 1e-4, errs
    norms = np.linalg.norm(to_np(tr.eigvecs).reshape(n_ev, -1), axis=1)
    np.testing.assert_allclose(norms, 1.0, rtol=1e-5)


@pytest.mark.parametrize("model", MODELS)
def test_get_eigenvectors_patch_signs(pipes, model):
    """Two PCs under a patch mask. The QR sign rule flips the basis where
    prod(diag(R)) < 0, and the sign of R's diagonal follows the sign of the
    Householder pivot, each column's first element. Under a patch that
    element is a masked zero, whose sign (+0 or -0) is roundoff, so each
    eigenvector's sign is arbitrary in both packages: the port agrees with
    JAX up to each eigenvector's sign, |cosine| >= 0.9999 (measured >=
    0.99991), and the eigenvalues within 2e-3 (measured 1.0e-3: a sign flip
    mid-iteration probes the other side of the nonlinear x0 map)."""
    jr, tr = _eig_pair(pipes, model, 2, const=0.1, iters=21, seed=6, patch=True)
    cos = _cosines(tr.eigvecs, jr.eigvecs, 2)
    err = rel_err(to_np(tr.eigvals), np.asarray(jr.eigvals))
    assert np.all(np.abs(cos) >= 0.9999), cos
    assert err <= 2e-3
    masked = np.ones(tr.eigvecs.shape, bool)
    masked[:, :, 2:12] = False
    assert np.abs(to_np(tr.eigvecs)[masked]).max() <= 1e-6  # roundoff of the QR only


@pytest.mark.parametrize("n_ev", [1, 2])
@pytest.mark.parametrize("model", MODELS)
def test_finite_difference_probe_at_cli_const(pipes, model, n_ev):
    """One iteration at the CLI's c = 1e-3: the probe's direction and norm
    (module docstring)."""
    jr, tr = _eig_pair(pipes, model, n_ev, const=1e-3, iters=1, seed=7)
    cos = _cosines(tr.eigvecs, jr.eigvecs, n_ev)
    err = rel_err(to_np(tr.in_norms), np.asarray(jr.in_norms))
    assert np.all(cos >= 0.9999), cos
    assert err <= 1e-3
    assert tr.in_corrs.shape == jr.in_corrs.shape == (0, n_ev)


@pytest.mark.parametrize("shifted", [True, False])
@pytest.mark.parametrize("model", MODELS)
def test_apply_drift(pipes, model, shifted):
    """Two PCs combined into one row, from the output of a directional step."""
    c = _case(pipes, model, seed=8)
    rng = np.random.default_rng(9)
    vecs = rng.standard_normal((2,) + c["xt"].shape[1:]).astype(np.float32)
    vecs /= np.linalg.norm(vecs.reshape(2, -1), axis=1).reshape(2, 1, 1, *([1] * (vecs.ndim - 3)))
    vals = np.asarray([2.0, 0.5], np.float32)
    jprev, jx0 = jpc.forward_directional(c["jsolver"], c["jpair"], jnp.asarray(c["xt"]), K,
                                         jnp.asarray(c["z"]), 3.0, state=c["jst"])
    jout, jst = jpc.apply_drift(c["jsolver"], K, jprev, jx0, jnp.asarray(vecs),
                                jnp.asarray(vals), jnp.asarray(c["z"]), amount=2.0,
                                use_shifted_x0_for_noisepred=shifted, xt=jnp.asarray(c["xt"]),
                                state=c["jst"], return_state=True)
    tprev, tx0 = tpc.forward_directional(c["tsolver"], c["tpair"], _t(c["xt"]), K, _t(c["z"]),
                                         3.0, state=c["tst"])
    tout, tst = tpc.apply_drift(c["tsolver"], K, tprev, tx0, _t(vecs), _t(vals), _t(c["z"]),
                                amount=2.0, use_shifted_x0_for_noisepred=shifted,
                                xt=_t(c["xt"]), state=c["tst"], return_state=True)
    assert rel_err(to_np(tout), np.asarray(jout)) <= MODULE_TOL
    assert rel_err(to_np(tout), to_np(tprev)) > 1e-2  # the drift moved the step
    if model == "stable_audio":
        assert rel_err(to_np(tst.m1), np.asarray(jst.m1)) <= MODULE_TOL


@pytest.mark.parametrize("iters", [0, 16, 21, 50, 61])
def test_snapshot_iterations(iters):
    assert tpc.snapshot_iterations(iters) == jpc.snapshot_iterations(iters)
