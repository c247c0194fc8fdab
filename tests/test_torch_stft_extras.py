"""The port's STFT round trip (ops/stft.py: ``stft_transform``,
``inverse_stft``, ``griffin_lim``) against the JAX functions on the same
waves, with the JAX initial phase passed to Griffin-Lim, and the goldens of
tests/test_frontend.py (interior reconstruction, Griffin-Lim convergence).

Tolerance: 1e-5 relative (max abs error over max abs value)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audioeditingcode_tpu.ops import stft as jst
from audioeditingcode_tpu_torch.ops import stft as tst

TOL = 1e-5


def _wave(n=16000, seed=0):
    t = np.arange(n, dtype=np.float32) / 16000
    w = 0.4 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 1234 * t)
    w += 0.01 * np.random.default_rng(seed).standard_normal(n)
    return w[None].astype(np.float32)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


CONFIGS = {"default": dict(),
           "short_window": dict(filter_length=512, hop_length=128, win_length=400)}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_stft_transform_matches_jax(name):
    jcfg, tcfg = jst.MelConfig(**CONFIGS[name]), tst.MelConfig(**CONFIGS[name])
    w = _wave()
    jm, jp = jst.stft_transform(jnp.asarray(w), jcfg)
    tm, tp = tst.stft_transform(torch.from_numpy(w), tcfg)
    assert _rel(tm, jm) <= TOL
    # the phase where the bin has energy (elsewhere it is the angle of noise)
    keep = np.asarray(jm) > 1e-3 * np.asarray(jm).max()
    d = np.angle(np.exp(1j * (tp.numpy() - np.asarray(jp))))
    assert np.abs(d[keep]).max() <= 1e-3


@pytest.mark.parametrize("name", list(CONFIGS))
def test_inverse_stft_matches_jax(name):
    jcfg, tcfg = jst.MelConfig(**CONFIGS[name]), tst.MelConfig(**CONFIGS[name])
    jm, jp = jst.stft_transform(jnp.asarray(_wave()), jcfg)
    want = np.asarray(jst.inverse_stft(jm, jp, jcfg))
    got = tst.inverse_stft(torch.from_numpy(np.asarray(jm)), torch.from_numpy(np.asarray(jp)),
                           tcfg)
    assert _rel(got, want) <= TOL


def test_griffin_lim_matches_jax_with_its_phase():
    cfg, tcfg = jst.MelConfig(), tst.MelConfig()
    mag, _ = jst.stft_transform(jnp.asarray(_wave(8000)), cfg)
    rng = jax.random.PRNGKey(3)
    phase = jax.random.uniform(rng, mag.shape, minval=-np.pi, maxval=np.pi)
    want = np.asarray(jst.griffin_lim(mag, cfg, n_iters=4, rng=rng))
    got = tst.griffin_lim(torch.from_numpy(np.asarray(mag)), tcfg, n_iters=4,
                          phase=torch.from_numpy(np.asarray(phase)))
    assert _rel(got, want) <= TOL


def test_roundtrip_reconstruction_golden():
    """tests/test_frontend.py's golden: the interior reconstructs within 1e-3."""
    cfg = tst.MelConfig()
    t = np.arange(16000, dtype=np.float32) / 16000
    wave = (0.4 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 1234 * t))[None]
    mag, phase = tst.stft_transform(torch.from_numpy(wave.astype(np.float32)), cfg)
    rec = tst.inverse_stft(mag, phase, cfg).numpy()
    n = min(rec.shape[-1], wave.shape[-1])
    assert np.abs(rec[0, 1024:n - 1024] - wave[0, 1024:n - 1024]).max() < 1e-3


def test_griffin_lim_converges_golden():
    """tests/test_frontend.py's golden, with the initial phase drawn from a
    seeded generator."""
    cfg = tst.MelConfig()
    t = np.arange(8000, dtype=np.float32) / 16000
    wave = torch.from_numpy((0.5 * np.sin(2 * np.pi * 440 * t))[None].astype(np.float32))
    mag, _ = tst.stft_transform(wave, cfg)

    def rel_err(n_iters):
        rec = tst.griffin_lim(mag, cfg, n_iters=n_iters,
                              generator=torch.Generator().manual_seed(0))
        mag_rec, _ = tst.stft_transform(rec, cfg)
        n = min(mag.shape[-1], mag_rec.shape[-1])
        return float(torch.linalg.norm(mag_rec[..., :n] - mag[..., :n]) / torch.linalg.norm(mag))

    e0, e20 = rel_err(0), rel_err(20)
    assert e20 < 0.35, e20
    assert e20 < 0.6 * e0, (e0, e20)
