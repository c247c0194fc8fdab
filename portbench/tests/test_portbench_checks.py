"""The comparison that decides ``correct``, shown to fail: the controls (the
reference in the precision below the configuration's, in the port's place)
and the port broken underneath, on the tiny configurations on the CPU. The
runs skip the harness's look for a card and drive the rest of a run.

Tiny limits: the port's tiny runs read at most ~2e-5 on every number (the
same float32 arithmetic on both sides, summed in another order); 1e-3
sits well above that and well below what the controls and faults read.
The exchange between chips is no fault these cells can have: each runs on
one card.
"""

import argparse
import os

import pytest
import torch

import tiny
from pbharness import cli

TINY_LIMIT = 1e-3
EDIT_LIMITS = {k: TINY_LIMIT for k in ("encode_rel", "model_rel", "step_rel", "decode_rel")}
PCX_LIMITS = {k: TINY_LIMIT for k in ("traj_rel", "norm0_rel", "step_norm_rel", "qr_rel")}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(str(tmp_path_factory.mktemp("tinybench")), limits={
        "tiny-sa-edit": EDIT_LIMITS, "tiny-aldm-edit": EDIT_LIMITS, "tiny-sa-pcx": PCX_LIMITS})


def run(root, workload, seed=2 ** 31 + 7, seconds=2.0, control=None):
    args = argparse.Namespace(workload=workload, seed=seed, seconds=seconds, trace=0,
                              root=root, device="cpu", control=control)
    return cli.run_once(args, t0=0.0)


SECONDS = {"tiny-sa-edit": 2.0, "tiny-aldm-edit": 2.0, "tiny-sa-pcx": 2.0}


@pytest.mark.parametrize("workload,control", [("tiny-sa-edit", "fp8"),
                                              ("tiny-aldm-edit", "fp8"),
                                              ("tiny-sa-pcx", "tf32")])
def test_control_is_not_correct(root, workload, control):
    """The port passes; the control, on the same samples, fails a number."""
    res = run(root, workload, seconds=SECONDS[workload], control=control)
    assert res["correct"] is True, res["checks"]
    ctrl = res["notes"][0]["checks"]
    limits = {n: c["limit"] for n, c in res["checks"].items()}
    assert any(v > limits[n] for n, v in ctrl.items()), ctrl


def _solver_step_unchanged(monkeypatch):
    from audioeditingcode_tpu_torch.editing import solvers

    for cls in (solvers.CosineDPMSolver, solvers.DDIMSolver):
        monkeypatch.setattr(cls, "reverse_step", lambda self, state, k, xt, out, z: (state, xt))


def _half_batch(monkeypatch):
    """The second half of every forward's rows is the mean of the first's."""
    from audioeditingcode_tpu_torch.models import pipeline, pipeline1d

    for cls in (pipeline.LatentAudioPipeline, pipeline1d.StableAudioPipeline):
        orig = cls.make_eps_pair

        def make(self, uncond, cond, orig=orig):
            pair = orig(self, uncond, cond)

            def broken(x_u, x_c, k):
                outs = []
                for e in pair(x_u, x_c, k):
                    if e is not None and e.shape[0] >= 2:
                        h = e.shape[0] // 2
                        e = torch.cat([e[:h], e[:h].mean(0, keepdim=True).expand_as(e[h:])])
                    outs.append(e)
                return tuple(outs)

            return broken

        monkeypatch.setattr(cls, "make_eps_pair", make)


def _answer_altered(monkeypatch):
    """The last clip's decoded audio comes out at half its level."""
    from audioeditingcode_tpu_torch.models import pipeline, pipeline1d

    for cls in (pipeline.LatentAudioPipeline, pipeline1d.StableAudioPipeline):
        orig = cls.decode_to_mel

        def decode(self, x, orig=orig):
            y = orig(self, x).clone()
            y[-1] = y[-1] * 0.5
            return y

        monkeypatch.setattr(cls, "decode_to_mel", decode)


@pytest.mark.parametrize("workload", ["tiny-sa-edit", "tiny-aldm-edit"])
@pytest.mark.parametrize("fault", [_solver_step_unchanged, _half_batch, _answer_altered])
def test_edit_faults_are_not_correct(root, monkeypatch, workload, fault):
    fault(monkeypatch)
    res = run(root, workload, seconds=SECONDS[workload])
    assert res["correct"] is False, res["checks"]


def _pc_step_unchanged(monkeypatch):
    """The directional step returns the x0 prediction it was given, as if
    the probe had not moved it."""
    from audioeditingcode_tpu_torch.editing import pc_drift

    orig = pc_drift.forward_directional

    def step(*a, **k):
        k = dict(k, amount=0.0)
        return orig(*a, **k)

    monkeypatch.setattr(pc_drift, "forward_directional", step)


def _pc_norms_altered(monkeypatch):
    """The iteration norms come out 1.5 times their value."""
    from audioeditingcode_tpu_torch.editing import pc_drift

    orig = pc_drift.get_eigenvectors
    monkeypatch.setattr(pc_drift, "get_eigenvectors",
                        lambda *a, **k: (lambda r: r._replace(in_norms=r.in_norms * 1.5))(
                            orig(*a, **k)))


def _pc_qr_skipped(monkeypatch):
    """The QR is left out: each iterate is its rows normalised on their own,
    as if every R were the identity."""
    from audioeditingcode_tpu_torch.editing import pc_drift

    class Linalg:
        def __getattr__(self, name):
            return getattr(torch.linalg, name)

        @staticmethod
        def qr(a, mode="reduced"):
            return a, torch.eye(a.shape[1], dtype=a.dtype, device=a.device)

    class Torch:
        linalg = Linalg()

        def __getattr__(self, name):
            return getattr(torch, name)

    monkeypatch.setattr(pc_drift, "torch", Torch())


@pytest.mark.parametrize("fault", [_pc_step_unchanged, _half_batch, _pc_norms_altered,
                                   _pc_qr_skipped])
def test_pcx_faults_are_not_correct(root, monkeypatch, fault):
    fault(monkeypatch)
    res = run(root, "tiny-sa-pcx", seconds=SECONDS["tiny-sa-pcx"])
    assert res["correct"] is False, res["checks"]


@pytest.mark.cuda
def test_card_controls_are_not_correct(root):
    """On the card (``python -m pytest portbench/tests -m cuda``): the tiny
    cells on the card's kernels and libraries pass, and their controls
    fail."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for workload, control in (("tiny-sa-edit", "fp8"), ("tiny-sa-pcx", "tf32")):
        args = argparse.Namespace(workload=workload, seed=11, seconds=2.0, trace=1,
                                  root=root, device="cuda", control=control)
        res = cli.run_once(args, t0=0.0)
        assert res["correct"] is True, res["checks"]
        ctrl = res["notes"][0]["checks"]
        assert any(v > res["checks"][n]["limit"] for n, v in ctrl.items()), ctrl
