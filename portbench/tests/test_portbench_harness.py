"""The harness on the CPU: lookup by name, the counting functions, the
result line, and what the harness and the reference import."""

import json
import os
import subprocess
import sys

import pytest
import torch

import tiny
from pbharness import counting, spec

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
RUN = os.path.join(ROOT, "portbench", "run.py")


def test_real_cells_resolve():
    """Every cell of BENCHMARK.json finds its configuration, traffic and
    per-layer readers, and lists setup_s and another end-to-end metric."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"], ROOT)
        assert cell.config["name"] == w["config"]
        assert cell.traffic["kind"] in ("edit", "pcx")
        names = [e["name"] for e in cell.end_to_end]
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        for e in cell.per_layer:
            assert callable(spec.metric_reader(ROOT, e["name"]))


def test_a_new_cell_is_new_files(tmp_path):
    """A configuration, a traffic mix, a metric and a cell added as files
    in another root are found by name, next to the existing ones."""
    root = tiny.make_root(str(tmp_path))
    with open(os.path.join(root, "portbench", "metrics", "probe_metric.py"), "w") as f:
        f.write("def read(ctx):\n    return 42.0\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["per_layer"].append({"name": "probe_metric", "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": "editing loop",
                               "moves": "edit_steps_per_s", "workloads": ["tiny-sa-edit"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    cell = spec.load_cell("tiny-sa-edit", root)
    assert cell.config["model_id"] == "test/tiny-stable-audio"
    assert cell.traffic["steps"] == 6
    assert "probe_metric" in [e["name"] for e in cell.per_layer]
    assert spec.metric_reader(root, "probe_metric")(None) == 42.0
    # the real readers are still found from the other root
    assert callable(spec.metric_reader(root, "idle_pct.edit"))
    assert spec.load_cell("tiny-sa-pcx", root).traffic["kind"] == "pcx"


def test_attention_count_by_hand():
    w = counting.attention_work(8, 1025, 1025, 24, 12, 64, torch.bfloat16)
    assert w.flops == 4 * 8 * 24 * 1025 * 1025 * 64
    assert w.exps == 8 * 24 * 1025 * 1025
    assert w.bytes == 2 * (2 * 8 * 1025 * 24 * 64 + 2 * 8 * 1025 * 12 * 64)
    # products bound it: 51.6 GFLOP at 989 TFLOP/s (exponentials 48 us)
    assert w.bound_s(torch.bfloat16) == 4 * 8 * 24 * 1025 * 1025 * 64 / 989e12


def test_swiglu_count_by_hand():
    w = counting.swiglu_work(4100, 1536, 6144, torch.float32)
    assert w.flops == 2 * 4100 * 1536 * 12288
    assert w.exps == 4100 * 6144
    assert w.bytes == 4 * (4100 * 1536 + 12288 * 1536 + 4100 * 6144) + 4 * 12288
    # one float32 product each, at the TF32 peak
    assert w.bound_s(torch.float32) == pytest.approx(w.flops / 495e12)


def test_dit_forward_count_by_hand():
    """One Stable Audio forward of 8 rows: every projection, attention and
    feed-forward product, counted by hand from the published widths."""
    cfg = json.load(open(os.path.join(ROOT, "portbench", "configs",
                                      "stable-audio-open-1.0.json")))
    fc = counting.count_forward(cfg, (64, 1024), 8)
    B, L, S, E, H, KV, D, F, K, X = 8, 1024, 1025, 1536, 24, 12, 64, 6144, 130, 768
    per_layer = (2 * S * E * (E + 2 * KV * D + E)  # self q, k, v, out
                 + 4 * S * S * H * D  # QK^T, PV
                 + 2 * S * E * E + 2 * K * X * 2 * KV * D + 2 * S * E * E  # cross q, k, v, out
                 + 4 * S * K * H * D
                 + 2 * S * E * 2 * F + 2 * S * F * E)  # SwiGLU, down
    edges = (2 * L * 64 * 64 + 2 * L * 64 * E  # pre-conv, proj_in
             + 2 * S * E * 64 + 2 * L * 64 * 64  # proj_out (all tokens), post-conv
             + 2 * 256 * E + 2 * E * E  # timestep MLP
             + 2 * 1536 * E + 2 * E * E  # global MLP
             + 2 * K * (768 * X + X * X))  # cross-attention input MLP
    assert fc.flops == B * (24 * per_layer + edges)
    assert fc.b1 == ((8, 1025, 1025, 24, 12, 64),) * 24
    assert fc.b3 == ((8200, 1536, 6144),) * 24


def test_window_mfu_and_host_probes():
    """mfu_pct counts the whole window's forwards over its device-clock
    length at the configuration's peak; the host probes fall every
    stride-th step and keep a step away from the traced stretch."""
    from pbharness import readers
    from pbharness.kinds.common import is_probe

    fc = counting.ForwardCount(flops=2.0e12, b1=(), b3=())
    ctx = readers.Context(dtype=torch.bfloat16, forward=fc, trace=None,
                          host_step_ms=[3.0, 1.0, 2.0], window_forwards=500, window_s=10.0)
    assert readers.mfu_pct(ctx) == pytest.approx(100.0 * 2.0e12 * 500 / (10.0 * 989e12))
    assert readers.host_ms_per_step(ctx) == 2.0
    assert readers.mfu_pct(readers.Context(torch.float32, fc, None, [])) is None
    probes = [s for s in range(200) if is_probe(s, 20, 10, 40)]
    assert probes == [70, 90, 110, 130, 150, 170, 190]
    assert [s for s in range(30) if is_probe(s, 10, 5, 12)] == [25]


@pytest.mark.parametrize("mode", ["f32", "fp8"])
def test_reference_attention_in_blocks(monkeypatch, mode):
    """The reference's attention worked out in blocks of (batch, head) pairs
    equals the unblocked one, the control's one probability scale too."""
    from pbreference import precision
    from pbreference.ops import flash_attention

    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn((3, 40, 4, 8), generator=g) for _ in range(3))
    monkeypatch.setattr(precision, "MODE", mode)
    whole = flash_attention.fused_attention(q, k[:, :, :2], v[:, :, :2])
    monkeypatch.setattr(flash_attention, "BLOCK", 40 * 40 * 5)  # 5 pairs, the last 2
    blocked = flash_attention.fused_attention(q, k[:, :, :2], v[:, :, :2])
    torch.testing.assert_close(blocked, whole, rtol=1e-6, atol=1e-6)


def test_result_line_and_imports(tmp_path):
    """A whole tiny run on the CPU through run.py: the last line is the
    result object with its keys in order, ``checks`` last; the numbers are
    printed on standard error beside their limits; the run loaded no JAX
    (run.py refuses to print otherwise)."""
    root = tiny.make_root(str(tmp_path), limits={"tiny-sa-edit": {
        "encode_rel": 1e-3, "model_rel": 1e-3, "step_rel": 1e-3, "decode_rel": 1e-3}})
    r = subprocess.run([sys.executable, RUN, "--workload", "tiny-sa-edit", "--seed",
                        str(2 ** 31 + 12345), "--seconds", "2", "--trace", "0", "--root", root,
                        "--device", "cpu"], capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["metrics"]) == {"setup_s", "edit_steps_per_s", "edit_step_ms_p95"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(line["checks"]) == {"encode_rel", "model_rel", "step_rel", "decode_rel"}
    tail = r.stderr.strip().splitlines()[-4:]
    assert all(t.startswith("check ") and " limit " in t for t in tail)


def test_a_run_refuses_without_a_card(tmp_path):
    root = tiny.make_root(str(tmp_path))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, RUN, "--workload", "tiny-sa-edit", "--seed", "1",
                        "--seconds", "1", "--trace", "0", "--root", root],
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_a_run_refuses_without_the_port(tmp_path):
    """A directory with only BENCHMARK.json and portbench/ runs nothing."""
    import shutil

    shutil.copytree(os.path.join(ROOT, "portbench"), os.path.join(tmp_path, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    r = subprocess.run([sys.executable, os.path.join(tmp_path, "portbench", "run.py"),
                        "--workload", "sao-edit-bf16-b4", "--seed", "1", "--seconds", "1",
                        "--trace", "0", "--device", "cpu"],
                       capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert r.returncode != 0 and r.stdout.strip() == ""


def _modules_after(code: str) -> set:
    r = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                       capture_output=True, text=True, timeout=300,
                       cwd=os.path.join(ROOT, "portbench"))
    assert r.returncode == 0, r.stderr[-2000:]
    return set(json.loads(r.stdout.strip().splitlines()[-1]))


def test_harness_imports_no_jax():
    """What run.py imports, the port's modules of every kind included,
    holds no module whose top-level name is jax, jaxlib, flax or the JAX
    package (compared whole: the port's name begins with the latter)."""
    tops = _modules_after(
        "import sys; sys.path[:0] = ['.', '..']\n"
        "import run\n"
        "from pbharness.kinds import edit, pcx\n"
        "edit.port_api({'family': 'stable-audio', 'model_id': 'stabilityai/stable-audio-open-1.0'})\n"
        "edit.port_api({'family': 'audioldm', 'model_id': 'cvssp/audioldm-s-full-v2'})\n"
        "pcx._modules(False)\n"
        "import audioeditingcode_tpu_torch.models.pipeline1d, audioeditingcode_tpu_torch.models.pipeline\n")
    assert "audioeditingcode_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "audioeditingcode_tpu"}


def test_reference_imports_nothing_of_the_port():
    tops = _modules_after(
        "import sys; sys.path[:0] = ['.']\n"
        "import pbreference.models.pipeline1d, pbreference.models.pipeline\n"
        "import pbreference.editing.batched, pbreference.editing.pc_drift\n"
        "import pbreference.editing.cfg, pbreference.audio, pbreference.precision\n")
    assert "pbreference" in tops
    assert not tops & {"audioeditingcode_tpu_torch", "audioeditingcode_tpu", "jax", "flax",
                       "pbharness"}
