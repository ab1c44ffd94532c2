"""The port's train launcher, held against repro's `python -m
repro.launch.train` on the CPU: the same reduced run (8 steps, a save
every 4, two domains lost at step 6) trains the same sequence of steps
(the reference's loop quirk included: the resume trains the restored
step's batch, then the loop goes on from its range), repairs the same
blocks, prices the repair the same (1e-6 rtol), prints the same lines
with their numbers masked, and leaves the same checkpoints. The losses
themselves differ, since the two packages draw their initial params from
different generators."""
import contextlib
import io
import re
import sys

import numpy as np
import pytest
import torch

import repro.launch.train as jtrain
from repro.data.pipeline import SyntheticStream as JStream
from repro_torch.data.pipeline import SyntheticStream
from repro_torch.launch import train

ARGS = ["--steps", "8", "--ckpt-every", "4", "--fail-at", "6"]


def _record_steps(monkeypatch, cls) -> list:
    steps = []
    batch_at = cls.batch_at

    def recording(self, step, **kw):
        steps.append(step)
        return batch_at(self, step, **kw)

    monkeypatch.setattr(cls, "batch_at", recording)
    return steps


def _masked(text: str) -> list[str]:
    text = text.replace("elastic restart", "restart")
    return [re.sub(r"\d+\.\d+(e[+-]\d+)?", "X", line)
            for line in text.splitlines()]


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    d = tmp_path_factory.mktemp("ref_ckpt")
    steps = _record_steps(mp, JStream)
    mp.setattr(sys, "argv", ["train", *ARGS, "--ckpt-dir", str(d)])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jtrain.main()
    mp.undo()
    return out.getvalue(), steps, d


def test_run_matches_reference(reference_run, monkeypatch, capsys, tmp_path):
    ref_out, ref_steps, ref_dir = reference_run
    steps = _record_steps(monkeypatch, SyntheticStream)
    state, records = train.run([*ARGS, "--ckpt-dir", str(tmp_path),
                                "--device", "cpu"])
    out = capsys.readouterr().out
    assert steps == ref_steps == [0, 1, 2, 3, 4, 5, 5, 7]
    assert _masked(out) == _masked(ref_out)
    # repair counts and the priced repair, from the printed line
    pat = r"repaired (\d+) blocks \((\d+) stripes\), scheme sim time (\S+),"
    got, want = re.search(pat, out), re.search(pat, ref_out)
    assert got.groups()[:2] == want.groups()[:2]
    np.testing.assert_allclose(float(got.group(3)), float(want.group(3)),
                               rtol=1e-6)
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        sorted(p.name for p in ref_dir.iterdir()) == \
        ["step_00000004", "step_00000008"]
    # the records: every step, the repair, both saves
    assert [r["step"] for r in records if r["event"] == "step"] == steps
    repair, = [r for r in records if r["event"] == "repair"]
    assert (repair["step"], repair["resumed_at"]) == (6, 5)
    # the reduced state is one stripe on domains 0-5: 6 and 7 hold no
    # file, and a missing file counts as lost (as in the reference)
    assert repair["lost_domains"] == [1, 5, 6, 7]
    assert repair["blocks_repaired"] == int(got.group(1))
    saves = [r for r in records if r["event"] == "save"]
    assert [r["step"] for r in saves] == [4, 8]
    assert all(set(r["seconds"]) == {"snapshot", "layout", "encode", "d2h",
                                     "crc", "write"} for r in saves)
    assert int(state["step"]) == 7
    assert all(np.isfinite(r["loss"]) for r in records
               if r["event"] == "step")


def test_resume_from_latest(tmp_path, capsys):
    train.run(["--steps", "5", "--ckpt-every", "2", "--ckpt-dir",
               str(tmp_path), "--device", "cpu"])
    state, records = train.run(["--steps", "7", "--resume", "--ckpt-dir",
                                str(tmp_path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[train] resumed from step 5 (repaired 0 blocks)" in out
    assert [r["step"] for r in records if r["event"] == "step"] == [5, 6]
    assert int(state["step"]) == 7


def test_device_none_raises_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.run(["--steps", "1", "--ckpt-dir", str(tmp_path)])
    assert not any(tmp_path.iterdir())
