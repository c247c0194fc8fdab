"""Multi-device editing of the port (``parallel/``) against the JAX package
on the CPU: the mesh sizing rules, the tensor-parallel UNet and DiT (the
SwiGLU weight split in halves), the sequence-parallel DiT and its
attention route, each on gloo ranks that ``parallel.launch.spawn`` starts
(tests/test_torch_parallel_helpers.py holds what they run), against the
JAX forward on the virtual CPU devices of tests/conftest.py, as
tests/test_mesh.py runs it.

Tolerances: against JAX, 1e-4 relative (max abs error over max abs value:
the tests/test_torch_stable_audio_modules.py bound of one denoiser call);
tp = 2 against tp = 1 of the port, bit-equal: each rank computes its
output channels with the same float32 ops as one rank does (both on the
one intra-op thread a CPU rank runs; against this process's eight threads
the UNet parts by 1.4e-6, the CPU ops summing in another order); sp
against the unsplit port, 1e-5 relative (the same per-token ops on other
row counts; the plain route measured bit-equal, the kernel route's plain
version 1.2-1.5e-6 from the dispatcher's plain path the unsplit port
takes below 1024 tokens).
Each case gives its ranks a join timeout; each takes under 30 s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audioeditingcode_tpu.parallel import mesh as jmesh
from audioeditingcode_tpu_torch.ops import flash_attention as fa
from audioeditingcode_tpu_torch.parallel import mesh as tmesh
from audioeditingcode_tpu_torch.parallel.launch import spawn
from test_torch_helpers import (
    jax_tiny_pipeline,
    jax_tiny_stable_audio,
    port_tiny_pipeline,
    port_tiny_stable_audio,
    rel_err,
)
import test_torch_parallel_helpers as ranks

STEPS = 4
JAX_TOL = 1e-4
PORT_TOL = 1e-5
JOIN_S = 120
MEL, SA = "test/tiny-audioldm", "test/tiny-stable-audio"


@pytest.mark.parametrize("n,dp,tp,sp", [
    (8, None, None, None), (8, 2, None, None), (8, None, 4, None), (6, None, None, None),
    (1, None, None, None), (8, None, None, 2), (8, 2, 2, 2), (4, 1, 2, 2), (1, 1, 1, 1),
    (2, None, None, 1), (8, 3, None, None), (8, 2, 2, None), (4, 1, 1, 2)])
def test_mesh_shape_matches_jax_make_mesh(n, dp, tp, sp):
    """The sizing rules and asserts of JAX make_mesh: an explicit sp (1
    included) gives the 3-axis mesh; without it tp defaults to 2 on an even
    count; dp * tp (* sp) must be n."""
    try:
        want = dict(jmesh.make_mesh(n, dp=dp, tp=tp, sp=sp).shape)
    except AssertionError:
        with pytest.raises(AssertionError):
            tmesh.mesh_shape(n, dp, tp, sp)
        return
    got = tmesh.mesh_shape(n, dp, tp, sp)
    assert got == want and list(got) == list(want)


def test_make_mesh_lays_ranks_out_row_major():
    """Four gloo ranks as (dp, tp, sp) = (2, 1, 2): rank = (d * tp + t) * sp
    + s, as mesh_utils lays devices out; each axis group holds the ranks
    that differ on that axis alone; a shard of 3 rows over 2 ranks is
    padded to 2 rows and gathers back to the 3."""
    out = spawn(ranks.mesh_layout, 4, 2, 1, 2, timeout=JOIN_S)
    for r, rec in enumerate(out):
        d, t, s = rec["coords"]["dp"], rec["coords"]["tp"], rec["coords"]["sp"]
        assert rec["rank"] == r == (d * 1 + t) * 2 + s
        assert rec["shape"] == {"dp": 2, "tp": 1, "sp": 2}
        assert rec["groups"] == {"dp": [s, 2 + s], "tp": [r], "sp": [2 * d, 2 * d + 1]}
        for name, (shape, rows) in rec["round_trips"].items():
            assert shape == ((3, 2) if name == "tp" else (2, 2))
            assert rows == [[0.0, 0.0], [1.0, 1.0], [2.0, 2.0]]


@pytest.fixture(scope="module")
def mel():
    jpipe = jax_tiny_pipeline(STEPS)
    return jpipe, port_tiny_pipeline(STEPS, jpipe)


@pytest.fixture(scope="module")
def stable_audio():
    jpipe = jax_tiny_stable_audio(STEPS)
    return jpipe, port_tiny_stable_audio(STEPS, jpipe)


def _jax_denoise(jpipe, x, k, cfg):
    den = jpipe.make_denoiser(jpipe.encode_text([""], negative=True),
                              jpipe.encode_text(["a violin"]),
                              jnp.full((1,) + x.shape[1:], cfg))
    return np.asarray(jax.jit(den)(jnp.asarray(x), jnp.asarray(k)))


def _port_denoise(model_id, pipe, x, k, cfg, **kw):
    return ranks.denoise(model_id, STEPS, ranks.pipeline_states(pipe), x, k, cfg, **kw)


@pytest.mark.parametrize("model", ["unet", "dit"])
def test_tp2_forward_matches_jax_and_tp1(mel, stable_audio, model):
    """A CFG denoiser call of the tiny AudioLDM UNet (convolutions, attention
    projections) and of the tiny DiT (with the SwiGLU weight split in
    halves) at tp = 2 against the JAX forward and the port at tp = 1 (one
    rank, so both run on one thread)."""
    model_id, (jpipe, pipe) = (MEL, mel) if model == "unet" else (SA, stable_audio)
    shape = (1, 4, 15, 32) if model == "unet" else (1, 4, pipe.sample_size)
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    want = _jax_denoise(jpipe, x, 1, 4.0)
    states = ranks.pipeline_states(pipe)
    one = spawn(ranks.denoise, 1, model_id, STEPS, states, x, 1, 4.0, timeout=JOIN_S)[0]
    out = spawn(ranks.denoise, 2, model_id, STEPS, states, x, 1, 4.0, 1, 2, None,
                timeout=JOIN_S)
    assert out[0]["mesh"] == {"dp": 1, "tp": 2} and one["mesh"] is None
    np.testing.assert_array_equal(out[0]["out"], out[1]["out"])
    np.testing.assert_array_equal(out[0]["out"], one["out"])
    assert rel_err(out[0]["out"], want) < JAX_TOL


def _jax_sp_denoise(x, k, cfg, sp):
    """The JAX sp-sharded DiT forward (tests/test_mesh.py): the latent's
    sequence axis sharded over sp virtual devices; GSPMD gathers K/V."""
    jpipe = jax_tiny_stable_audio(STEPS)
    mesh = jmesh.make_mesh(sp, dp=1, tp=1, sp=sp)
    jpipe.dit_params = jmesh.shard_module_params(jpipe.dit_params, mesh)
    den = jpipe.make_denoiser(jpipe.encode_text([""], negative=True),
                              jpipe.encode_text(["a violin"]),
                              jnp.full((1,) + x.shape[1:], cfg))
    w = jax.device_put(jnp.asarray(x), jmesh.seq_sharding(mesh, x.ndim))
    with mesh:
        return np.asarray(jax.jit(den)(w, jnp.asarray(k)))


@pytest.mark.parametrize("sp,route", [(2, "kernel"), (4, "kernel"), (2, "plain")])
def test_sp_dit_matches_jax_sp_forward(stable_audio, sp, route):
    """The tiny DiT's 17 tokens (16 latents and the global token; 8 sp does
    not divide 17) split over sp gloo ranks, padded to 32: each rank's rows
    through every block, K/V gathered, the padded keys masked. The kernel
    route (the dispatcher's threshold lowered to 8 tokens, so the sp kernel
    path runs its plain version) and the plain route (17 < 1024) both
    against the JAX sp-sharded forward and the unsplit port."""
    _, pipe = stable_audio
    x = np.random.default_rng(sp).standard_normal((1, 4, pipe.sample_size)).astype(np.float32)
    want = _jax_sp_denoise(x, 2, 3.0, sp)
    one = _port_denoise(SA, pipe, x, 2, 3.0)["out"]
    min_seq = 8 if route == "kernel" else None
    out = spawn(ranks.denoise, sp, SA, STEPS, ranks.pipeline_states(pipe), x, 2, 3.0,
                1, 1, sp, min_seq, timeout=JOIN_S)
    assert out[0]["mesh"] == {"dp": 1, "tp": 1, "sp": sp}
    # one sp kernel call per layer and CFG forward (one forward: both streams)
    layers = pipe.dit.config.num_layers
    assert [o["sp_kernel_calls"] for o in out] == [layers if route == "kernel" else 0] * sp
    for o in out[1:]:
        np.testing.assert_array_equal(o["out"], out[0]["out"])
    assert rel_err(out[0]["out"], want) < JAX_TOL
    assert rel_err(out[0]["out"], one) < PORT_TOL


@pytest.mark.parametrize("sp", [2, 4])
def test_sp_blocked_attention_matches_full_attention(sp):
    """Grouped-query self-attention over 129 tokens with a partial rotary,
    split over sp ranks: the rotary at each row's global position, K/V
    gathered, the local rows against them with kv_len = 129, gathered back:
    the full attention's plain version, to float32 roundoff."""
    g = np.random.default_rng(sp)
    B, S, H, Hkv, D, rot = 2, 129, 8, 4, 32, 16
    q, k, v = (g.standard_normal((B, S, h, D)).astype(np.float32) for h in (H, Hkv, Hkv))
    ang = np.arange(S)[:, None] * np.exp(-np.arange(rot // 2) / (rot // 2))[None, :]
    cos = np.concatenate([np.cos(ang)] * 2, -1).astype(np.float32)
    sin = np.concatenate([np.sin(ang)] * 2, -1).astype(np.float32)
    out = spawn(ranks.sp_attention, sp, q, k, v, cos, sin, sp, 8, timeout=JOIN_S)
    tq, tk, tv, tc, ts = map(torch.from_numpy, (q, k, v, cos, sin))
    want = fa.attention_reference(fa._host_rotary(tq, tc, ts), fa._host_rotary(tk, tc, ts), tv)
    assert [o["sp_kernel_calls"] for o in out] == [1] * sp
    np.testing.assert_allclose(out[0]["out"], want.numpy(), atol=2e-6, rtol=1e-5)
    # and JAX's sp route (tests/test_mesh.py) computes the same function
    jwant = jax.nn.dot_product_attention(
        *(np.asarray(jax_rotary(x, cos, sin)) for x in (q, k)), v)
    np.testing.assert_allclose(out[0]["out"], np.asarray(jwant), atol=2e-5)


def jax_rotary(x, cos, sin):
    from audioeditingcode_tpu.ops import flash_attention as jfa

    return jfa._host_rotary(jnp.asarray(x), jnp.asarray(cos), jnp.asarray(sin))


@pytest.mark.parametrize("mutant,tp,sp", [("swiglu_plain_shard", 2, None),
                                          ("sp_without_kv_len", 1, 2)])
def test_mutants_fail_the_parity_checks(stable_audio, mutant, tp, sp):
    """The checks above catch a wrong split: a plain output-row shard of the
    SwiGLU weight (rank 0 would hold value rows only) and sp attention that
    leaves the padded keys unmasked each put the DiT far outside the
    tolerance against JAX."""
    jpipe, pipe = stable_audio
    x = np.random.default_rng(7).standard_normal((1, 4, pipe.sample_size)).astype(np.float32)
    want = _jax_denoise(jpipe, x, 1, 4.0)
    out = spawn(ranks.denoise, 2, SA, STEPS, ranks.pipeline_states(pipe), x, 1, 4.0, 1, tp,
                sp, 8, mutant, timeout=JOIN_S)
    assert rel_err(out[0]["out"], want) > 100 * JAX_TOL
