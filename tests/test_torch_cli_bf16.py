"""The port's ``--dtype bfloat16`` edit against the JAX CLI's bfloat16
edit on the CPU, on test/tiny-audioldm and test/tiny-stable-audio.

Both CLIs run in this process, as tests/test_torch_weights_cli.py runs
them, so that the port can be handed what the two packages make
differently: the JAX CLI's weights (its seed-0 init, carried over by the
bridge), its noise (drawn from the same keys and, as the JAX CLI draws it,
in the latent's dtype: bfloat16) and its bfloat16 encoder output w0. The
port's own w0 is held against JAX's first. Torch runs on two threads here,
so that the port's sums do not depend on the CPUs free at the time.

Tolerances. bfloat16 keeps 8 significant bits (unit roundoff 2**-9, about
2e-3). One pass of a tiny module rounds some 20-40 times on its way, and in
both packages it lands about 1 % from float32 (the tiny UNet, VAE encoder
and decoder and vocoder: 1.0-1.4 %, each package against float32 and the
two against each other). So w0, one encoder pass, is held to ROADMAP's
3e-2. The edit cannot be: at the CLI's ``--cfg_tar 12`` the guided eps is
12 times the difference of two bfloat16 forwards, and six steps of it put
either package's bfloat16 edit ~15 % (AudioLDM) from the same edit in
float32. The float32 edit here is the port's, from the same weights, noise
and w0; tests/test_torch_weights_cli.py holds the port's float32 edit to the
JAX one within 2e-4. So the edit is held as chip_smoke.py holds the card's
bfloat16 forwards: the port's bfloat16 edit lies no farther from that
float32 edit than 1.25 times JAX's does (a module that the port ran in
bfloat16 where JAX keeps float32, or the reverse, moves that ratio), and
the two bfloat16 edits lie within 1.25 * sqrt(2) times JAX's distance of
each other (two independent roundoffs of one size part by sqrt(2) times
it). The AudioLDM wav is held the same way. The Stable Audio wav is not:
the tiny random Oobleck decoder saturates on these latents
(test_torch_helpers.record_stable_audio_decodes)."""

import jax
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict
from scipy.io import wavfile

from audioeditingcode_tpu.cli import run as jrun
from audioeditingcode_tpu_torch.cli import run as trun
from audioeditingcode_tpu_torch.models.bridge import flax_to_torch_state_dict
from test_torch_helpers import write_stereo_wav, write_test_wav

STEPS = 6
SEED = 3
MODULE_TOL = 3e-2  # one bfloat16 module pass (ROADMAP's ground rule)
RATIO = 1.25  # the card's bfloat16 rule (chip_smoke.py phases 2 and 2b)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _params_f32(params):
    return flatten_dict(jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params))


@pytest.fixture
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run_jax(argv, monkeypatch):
    """The JAX CLI's run: its pipeline, its bfloat16 w0 and edited latent
    (taken from inside jit by debug callbacks) and its wav."""
    got = {}
    real_load, real_inv = jrun.load_model, jrun.inversion_forward_process
    real_rev = jrun.inversion_reverse_process

    def load(*a, **kw):
        got["pipe"] = real_load(*a, **kw)
        return got["pipe"]

    def inv(sched, den, w0, rng, **kw):
        got["w0_dtype"] = w0.dtype
        jax.debug.callback(lambda x: got.__setitem__("w0", np.asarray(x, np.float32)), w0)
        return real_inv(sched, den, w0, rng, **kw)

    def rev(*a, **kw):
        out = real_rev(*a, **kw)
        jax.debug.callback(lambda x: got.__setitem__("edit", np.asarray(x, np.float32)), out)
        return out

    with monkeypatch.context() as m:
        m.setattr(jrun, "load_model", load)
        m.setattr(jrun, "inversion_forward_process", inv)
        m.setattr(jrun, "inversion_reverse_process", rev)
        got["wav"] = wavfile.read(jrun.main(argv))[1]
    return got


def _run_port(argv, j, sa, monkeypatch):
    """The port CLI's run, handed the JAX run's weights, draws and w0: its
    own w0, its edited latent and its wav."""
    got = {}
    real_load, real_inv = trun.load_model, trun.inversion_forward_process
    real_rev = trun.inversion_reverse_process
    jp = j["pipe"]

    def load(*a, **kw):
        pipe = real_load(*a, **kw)
        mods = (((pipe.dit, jp.dit_params), (pipe.vae, jp.vae_params),
                 (pipe.projection, jp.projection_params)) if sa else
                ((pipe.unet, jp.unet_params), (pipe.vae, jp.vae_params),
                 (pipe.vocoder, jp.vocoder_params)))
        for mod, params in mods:
            mod.load_state_dict(flax_to_torch_state_dict(_params_f32(params), mod))
        rng = jax.random.PRNGKey(SEED)
        if sa:
            pipe.setup_duration()
            rng, enc_rng = jax.random.split(rng)
            shape = (1, pipe.sample_size, pipe.vae.config.decoder_input_channels)
            enc = np.asarray(jax.random.normal(enc_rng, shape, dtype=j["w0_dtype"]),
                             np.float32).transpose(0, 2, 1).copy()
            real_enc = pipe.vae_encode
            pipe.vae_encode = lambda x, noise=None: real_enc(x, torch.from_numpy(enc))
        got["rng"] = rng
        return pipe

    def inv(sched, den, w0, noise, **kw):
        got["w0"] = w0.float().numpy()
        z = jax.random.normal(got["rng"], (STEPS,) + tuple(w0.shape), dtype=j["w0_dtype"])
        z = torch.from_numpy(np.asarray(z, np.float32))
        return real_inv(sched, den, torch.from_numpy(j["w0"]).to(w0.dtype), z, **kw)

    def rev(*a, **kw):
        out = real_rev(*a, **kw)
        got["edit"] = out.float().numpy()
        return out

    with monkeypatch.context() as m:
        m.setattr(trun, "load_model", load)
        m.setattr(trun, "inversion_forward_process", inv)
        m.setattr(trun, "inversion_reverse_process", rev)
        got["wav"] = wavfile.read(trun.main(argv + ["--device", "cpu"]))[1]
    return got


@pytest.mark.parametrize("model_id", ["test/tiny-audioldm", "test/tiny-stable-audio"])
def test_bfloat16_edit_matches_the_jax_bfloat16_edit(model_id, tmp_path, monkeypatch,
                                                    two_threads):
    sa = model_id == "test/tiny-stable-audio"
    wav = (write_stereo_wav if sa else write_test_wav)(str(tmp_path / "clip.wav"),
                                                     seconds=0.3)
    argv = ["--model_id", model_id, "--init_aud", wav, "--num_diffusion_steps", str(STEPS),
            "--tstart", "4", "--seed", str(SEED), "--source_prompt", "a sine tone",
            "--target_prompt", "a loud trumpet"]

    def out(name):
        return ["--results_path", str(tmp_path / name)]

    j = _run_jax(argv + ["--dtype", "bfloat16"] + out("jax"), monkeypatch)
    assert str(j["w0_dtype"]) == "bfloat16"  # the JAX CLI's latents and draws
    t = _run_port(argv + ["--dtype", "bfloat16"] + out("port"), j, sa, monkeypatch)
    ref = _run_port(argv + ["--dtype", "float32"] + out("f32"), j, sa, monkeypatch)
    assert _rel(t["w0"], j["w0"]) <= MODULE_TOL

    e_jax = _rel(j["edit"], ref["edit"])
    e_port = _rel(t["edit"], ref["edit"])
    assert 0 < e_jax < 1, e_jax  # the bfloat16 runs took bfloat16 paths
    assert e_port <= RATIO * e_jax, (e_port, e_jax)
    assert _rel(t["edit"], j["edit"]) <= RATIO * np.sqrt(2) * e_jax

    for w in (t["wav"], j["wav"]):
        assert w.shape == ref["wav"].shape and np.any(w)
    if not sa:
        w_jax = _rel(j["wav"], ref["wav"])
        assert _rel(t["wav"], ref["wav"]) <= RATIO * w_jax, w_jax
        assert _rel(t["wav"], j["wav"]) <= RATIO * np.sqrt(2) * w_jax
