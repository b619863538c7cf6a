"""The convergence witness (``motionbert_tpu_torch.train.anchor``) and its
data (``motionbert_tpu_torch.data.synthetic``) against the JAX package's
``tools/make_synthetic_data.py``, ``tools/convert_h36m.py`` and
``motionbert_tpu.train.pose3d.train_with_config``, on the CPU."""

import json
import os
import pickle
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motionbert_tpu_torch.data.synthetic import convert_h36m, make_h36m_pickle
from motionbert_tpu_torch.train import anchor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# a small learnable-z set: subjects 1 and 5, 3 videos of 64-78 frames, cut
# into 16-frame clips at stride 8 (44 train clips, 5 steps an epoch at the
# smoke batch of 8; 24 test clips)
SMALL = dict(n_frames_per_video=64, seed=1, learnable_z=True,
             train_subjects=(1, 5), train_videos=3)


@pytest.fixture(autouse=True)
def one_thread():
    """The models here are tiny: one intra-op thread runs them faster than a
    pool that contends for the cores with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _small_set(root) -> None:
    """The smoke geometry's data under ``root``, where the module and the
    trainers look for it, with the marker that makes the module keep it."""
    root = str(root)
    make_h36m_pickle(os.path.join(root, "h36m_synth_anchor.pkl"), **SMALL)
    clips = os.path.join(root, "MB3D_f243s81", "H36M-SYN")
    convert_h36m(root, "h36m_synth_anchor.pkl", clips, n_frames=16,
                 data_stride=8)
    with open(os.path.join(clips, ".complete"), "w") as f:
        f.write("ok")


def _clips(path) -> list:
    out = []
    for split in ("train", "test"):
        names = sorted(os.listdir(os.path.join(path, split)))
        for name in names:
            with open(os.path.join(path, split, name), "rb") as f:
                out.append((split, name, pickle.load(f)))
    return out


def test_synthetic_set_equals_the_tools(tmp_path):
    """The port's pickle and clips, array by array, against the tools' at 2
    subjects x 1 video x 64 frames, clip 16, stride 8."""
    from tools.convert_h36m import convert_h36m as tools_convert
    from tools.make_synthetic_data import make_h36m_pickle as tools_pickle

    kw = dict(n_frames_per_video=64, seed=1, learnable_z=True,
              train_subjects=(1, 2), train_videos=1)
    port = make_h36m_pickle(str(tmp_path / "port" / "h36m.pkl"), **kw)
    ref = tools_pickle(str(tmp_path / "ref" / "h36m.pkl"), **kw)
    with open(tmp_path / "port" / "h36m.pkl", "rb") as f:
        assert pickle.load(f).keys() == port.keys() == ref.keys()
    for split in ("train", "test"):
        assert port[split].keys() == ref[split].keys()
        for k in ref[split]:
            assert port[split][k].dtype == ref[split][k].dtype, (split, k)
            np.testing.assert_array_equal(port[split][k], ref[split][k],
                                          err_msg=f"{split} {k}")
    # depth is the learnable map of the clean pose, not independent noise
    assert not np.array_equal(
        port["train"]["joint3d_image"],
        make_h36m_pickle(str(tmp_path / "free" / "h36m.pkl"),
                         **dict(kw, learnable_z=False))["train"][
            "joint3d_image"])

    counts = convert_h36m(str(tmp_path / "port"), "h36m.pkl",
                          str(tmp_path / "port" / "clips"), n_frames=16,
                          data_stride=8)
    tools_convert(str(tmp_path / "ref"), "h36m.pkl",
                  str(tmp_path / "ref" / "clips"), n_frames=16, data_stride=8)
    got = _clips(tmp_path / "port" / "clips")
    want = _clips(tmp_path / "ref" / "clips")
    assert counts == (sum(s == "train" for s, _, _ in want),
                      sum(s == "test" for s, _, _ in want))
    assert [(s, n) for s, n, _ in got] == [(s, n) for s, n, _ in want]
    assert counts[0] > 0 and counts[1] > 0
    for (_, name, a), (_, _, b) in zip(got, want):
        assert a.keys() == b.keys() == {"data_input", "data_label"}
        for k in a:
            assert a[k].dtype == b[k].dtype == np.float32
            np.testing.assert_array_equal(a[k], b[k], err_msg=name)


def test_recipe_is_the_jax_tools():
    path = list(sys.path)
    try:  # the tool puts its own directory on sys.path
        from tools import train_anchor
    finally:
        sys.path[:] = path
    for smoke in (False, True):
        assert dict(anchor.build_args("/w", smoke)) == dict(
            train_anchor.build_args("/w", smoke))
    for name in ("DATA_SEED", "TRAIN_SUBJECTS", "TRAIN_VIDEOS",
                 "FRAMES_PER_VIDEO"):
        assert getattr(anchor, name) == getattr(train_anchor, name), name


def _scalars(ckpt_dir) -> dict:
    """{tag: [value by epoch]} from a trainer's scalars.jsonl, unrounded."""
    trace: dict = {}
    with open(os.path.join(ckpt_dir, "logs", "scalars.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            trace.setdefault(rec["tag"], {})[rec["step"]] = rec["value"]
    return {t: [v for _, v in sorted(d.items())] for t, d in trace.items()}


# the same-init traces: both fp32 on the CPU, the same batches in the same
# order, so they part only by rounding, which AdamW's normalised steps carry
# along. Over the 15 steps the gaps measured up to 6.8e-8 relative on the
# epoch loss and 2.7e-5 mm on e1 (of ~1000 mm), on one torch thread or
# eight; the bars sit ~150x and ~370x above them
TRACE_LOSS_RTOL = 1e-5
TRACE_E1_ATOL_MM = 1e-2


def test_same_init_traces_match_jax_across_a_resume(tmp_path):
    """Both trainers from one JAX init (``model.init`` at PRNGKey(0)'s init
    key, as the JAX driver draws it), finetuned at the smoke geometry on the
    small learnable-z set for 3 epochs: 1 epoch, then a new call resuming
    from latest_epoch.ckpt (``opts.resume``; under finetune neither
    auto-resumes). The per-epoch loss_3d_pos and e1 agree."""
    from motionbert_tpu.core.checkpoint import save_checkpoint
    from motionbert_tpu.core.config import ConfigDict as JConfig
    from motionbert_tpu.models.factory import load_backbone as jbackbone
    from motionbert_tpu.train.pose3d import train_with_config as jtrain
    from motionbert_tpu_torch.train.pose3d import train_with_config

    _small_set(tmp_path)
    args = anchor.build_args(str(tmp_path), smoke=True)
    args.update(finetune=True, epochs=1)
    init_rng = jax.random.split(jax.random.PRNGKey(0))[1]
    jmodel = jbackbone(JConfig(dict(args)))
    params = jmodel.init(init_rng, jnp.zeros((1, args.clip_len, 17, 3)))[
        "params"]
    os.makedirs(tmp_path / "init")
    save_checkpoint(str(tmp_path / "init" / "init.ckpt"), epoch=0,
                    lr=args.learning_rate, params=params)

    def opts(side, resume):
        ckpt = tmp_path / side
        return types.SimpleNamespace(
            checkpoint=str(ckpt), pretrained=str(tmp_path / "init"),
            selection="init.ckpt", evaluate="", seed=0,
            resume=str(ckpt / "latest_epoch.ckpt") if resume else "")

    for epochs, resume, run in ((1, False, [0]), (3, True, [1, 2])):
        args.epochs = epochs
        jtrain(JConfig(dict(args)), opts("jax", resume))
        hist = train_with_config(args, opts("port", resume),
                                 device="cpu")["history"]
        assert [h["epoch"] for h in hist] == run
        assert all(h["steps"] == 5 and h["step_ms"] is None for h in hist)
    assert hist[0]["lr"] == pytest.approx(args.learning_rate * 0.99)

    got, want = _scalars(tmp_path / "port"), _scalars(tmp_path / "jax")
    for tag in ("loss_3d_pos", "Error P1"):
        assert len(got[tag]) == len(want[tag]) == 3, tag
    np.testing.assert_allclose(got["loss_3d_pos"], want["loss_3d_pos"],
                               rtol=TRACE_LOSS_RTOL)
    np.testing.assert_allclose(got["Error P1"], want["Error P1"], rtol=0,
                               atol=TRACE_E1_ATOL_MM)
    # it trained: the loss fell over the three epochs on both sides
    assert got["loss_3d_pos"][-1] < got["loss_3d_pos"][0]


def test_module_runs_both_phases_in_two_processes(tmp_path):
    """``--smoke --device cpu`` for 2 epochs with ``--mid 1`` through its two
    child processes: phase 2 resumes at epoch 1 at the decayed lr, and the
    trace carries the JAX witness's keys and this module's."""
    work = tmp_path / "anc"
    _small_set(str(work) + "_smoke")
    out = subprocess.run(
        [sys.executable, "-m", "motionbert_tpu_torch.train.anchor",
         "--smoke", "--device", "cpu", "--epochs", "2", "--mid", "1",
         "--workdir", str(work), "--fresh"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-4000:]
    trace = json.loads(out.stdout.strip().splitlines()[-1])
    with open(str(work) + "_smoke/" + anchor.TRACE_NAME) as f:
        assert json.load(f) == trace
    with open(anchor.JAX_TRACE) as f:
        assert set(json.load(f)) - {"measured_at_unix"} <= set(trace)
    assert {"nvidia_smi", "ms_per_step", "peak_memory_gib",
            "trained_clips_per_s", "checks"} <= set(trace)
    assert trace["resume"]["resumed_at_epoch"] == 1
    assert trace["checks"]["lr_at_resume"]["ok"]
    assert trace["checks"]["lr_at_resume"]["value"] == pytest.approx(
        2e-4 * 0.99, abs=1e-12)
    assert set(trace["checks"]) == {"resumed_at_epoch", "lr_at_resume",
                                    "adam_steps", "finite"}
    assert trace["checks"]["adam_steps"]["value"] == [10]
    assert len(trace["e1_mm_trace"]) == len(trace["loss_3d_pos_trace"]) == 2
    assert trace["steps_per_epoch"] == 5 and trace["ok"]
    assert trace["ms_per_step"] is None and trace["device"] == "cpu"


def test_module_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        anchor.run_phase(1, anchor.parse_args(["--workdir", "/nonexistent"]))


def test_witness_holds_the_bars(tmp_path):
    """The checks on made-up phases: the full recipe adds the two bars
    against the JAX trace, and a resume at the wrong epoch or lr, a
    non-finite value or a missed bar fails."""
    with open(anchor.JAX_TRACE) as f:
        ref = json.load(f)
    root = tmp_path / "w"
    logs = root / "checkpoint" / "logs"
    os.makedirs(logs)

    def run(e1, loss, start=20, lr=2e-4 * 0.99 ** 20, smoke=False,
            adam_steps=(30, 30)):
        torch.save({"optimizer": {"state": {
            i: {"step": torch.tensor(float(n))}
            for i, n in enumerate(adam_steps)}}},
            str(root / "checkpoint" / "latest_epoch.ckpt"))
        with open(logs / "scalars.jsonl", "w") as f:
            for i, (a, b) in enumerate(zip(e1, loss)):
                f.write(json.dumps({"step": i + 1, "tag": "Error P1",
                                    "value": a}) + "\n")
                f.write(json.dumps({"step": i + 1, "tag": "loss_3d_pos",
                                    "value": b}) + "\n")
        phase = dict(steps=[15], step_ms=[300.0], train_s=[5.0],
                     wall_s=10.0, peak_memory_bytes=2 ** 33,
                     device="NVIDIA H100 80GB HBM3")
        p2 = dict(phase, epochs=[start], lr=[lr])
        cli = anchor.parse_args(["--workdir", str(root)]
                                + (["--smoke"] if smoke else []))
        if smoke:
            os.rename(root, str(root) + "_smoke")
        try:
            return anchor.witness(cli, [dict(phase, epochs=[0], lr=[2e-4]),
                                        p2])
        finally:
            if smoke:
                os.rename(str(root) + "_smoke", root)

    good = run(ref["e1_mm_trace"], ref["loss_3d_pos_trace"])
    assert good["ok"] and set(good["checks"]) == {
        "resumed_at_epoch", "lr_at_resume", "adam_steps", "finite",
        "best_e1_mm", "last_loss_3d_pos"}
    assert good["checks"]["best_e1_mm"]["bar"] == pytest.approx(183.536,
                                                                abs=1e-3)
    assert good["checks"]["last_loss_3d_pos"]["bar"] == pytest.approx(
        0.0376750, abs=1e-6)
    assert good["ms_per_step"] == 300.0 and good["peak_memory_gib"] == 8.0
    assert good["trained_clips_per_s"] == pytest.approx(2 * 15 * 32 / 10.0)

    slow = [v * 1.25 for v in ref["e1_mm_trace"]]
    assert not run(slow, ref["loss_3d_pos_trace"])["checks"]["best_e1_mm"][
        "ok"]
    high = [v * 1.3 for v in ref["loss_3d_pos_trace"]]
    assert not run(ref["e1_mm_trace"], high)["checks"]["last_loss_3d_pos"][
        "ok"]
    nan = list(ref["e1_mm_trace"][:-1]) + [float("nan")]
    assert not run(nan, ref["loss_3d_pos_trace"])["checks"]["finite"]["ok"]
    assert not run(ref["e1_mm_trace"], ref["loss_3d_pos_trace"],
                   start=0)["checks"]["resumed_at_epoch"]["ok"]
    assert not run(ref["e1_mm_trace"], ref["loss_3d_pos_trace"],
                   lr=2e-4 * 0.99 ** 19)["checks"]["lr_at_resume"]["ok"]
    # AdamW's state lost at the resume: phase 2's steps alone
    assert not run(ref["e1_mm_trace"], ref["loss_3d_pos_trace"],
                   adam_steps=(15, 15))["checks"]["adam_steps"]["ok"]
    assert set(run(ref["e1_mm_trace"], ref["loss_3d_pos_trace"],
                   smoke=True)["checks"]) == {
        "resumed_at_epoch", "lr_at_resume", "adam_steps", "finite"}
