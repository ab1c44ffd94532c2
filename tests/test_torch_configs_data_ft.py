"""The port's configs, synthetic data and failure injection, held against
repro: every arch config and its reduced variant field by field, batches
byte for byte for equal seeds (the `tests/test_data.py` matrix), and
failure events and straggler verdicts equal (the `tests/test_ft.py`
matrix). All exact: these modules are plain Python and numpy."""
import dataclasses

import numpy as np
import pytest

from repro.configs import base as jbase
from repro.data import pipeline as jpipeline
from repro.ft import failures as jfailures
from repro_torch.configs import base
from repro_torch.data import pipeline
from repro_torch.ft import FailureEvent, FailureInjector, StragglerMonitor


def _fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("arch", jbase.ARCH_IDS)
def test_arch_configs_equal(arch):
    ours, theirs = base.get_arch(arch), jbase.get_arch(arch)
    for got, want in ((ours, theirs), (ours.reduced(), theirs.reduced())):
        a, b = _fields(got), _fields(want)
        if b["moe"] is not None:
            assert _fields(a.pop("moe")) == _fields(b.pop("moe"))
        assert a == b
        assert (got.hd, got.sub_quadratic) == (want.hd, want.sub_quadratic)
        assert base.applicable_shapes(got) == jbase.applicable_shapes(want)
    assert base.get_arch(arch.replace("_", "-")) == ours


def test_registry_equal():
    assert base.ARCH_IDS == jbase.ARCH_IDS
    assert {k: _fields(v) for k, v in base.SHAPES.items()} == \
        {k: _fields(v) for k, v in jbase.SHAPES.items()}
    with pytest.raises(KeyError, match="unknown arch"):
        base.get_arch("llama_7b")


def _streams(arch, seq_len, batch, seed=0):
    shape = base.ShapeConfig("t", "train", seq_len, batch)
    jshape = jbase.ShapeConfig("t", "train", seq_len, batch)
    ours = pipeline.SyntheticStream(base.get_arch(arch).reduced(), shape,
                                    pipeline.DataConfig(seed=seed))
    theirs = jpipeline.SyntheticStream(jbase.get_arch(arch).reduced(), jshape,
                                       jpipeline.DataConfig(seed=seed))
    return ours, theirs


def _assert_batches_equal(got: dict, want: dict):
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert np.array_equal(got[key], want[key]), key


@pytest.mark.parametrize("arch", ["qwen2_15b", "smollm_360m", "qwen2vl_2b",
                                  "whisper_medium"])
@pytest.mark.parametrize("seed", [0, 7])
def test_batches_equal(arch, seed):
    ours, theirs = _streams(arch, 16, 4, seed)
    assert np.array_equal(ours.successors, theirs.successors)
    for step in (0, 3, 4):
        _assert_batches_equal(ours.batch_at(step), theirs.batch_at(step))
    _assert_batches_equal(ours.batch_at(2, batch_size=2),
                          theirs.batch_at(2, batch_size=2))


def test_data_matrix_on_the_port():
    """tests/test_data.py's checks, on the port's stream."""
    ours, _ = _streams("qwen2_15b", 16, 4)
    a, c = ours.batch_at(3), ours.batch_at(4)
    assert not np.array_equal(a["tokens"], c["tokens"])
    ok = np.zeros(a["tokens"].shape, bool)
    for j in range(ours.successors.shape[1]):
        ok |= ours.successors[a["tokens"], j] == a["labels"]
    assert ok.all()
    wide, theirs = _streams("qwen2_15b", 16, 8)
    parts = [wide.host_batch_at(0, h, 4) for h in range(4)]
    assert np.array_equal(np.concatenate([p["tokens"] for p in parts]),
                          wide.batch_at(0)["tokens"])
    for h in range(4):
        _assert_batches_equal(parts[h], theirs.host_batch_at(0, h, 4))
    vl, jvl = _streams("qwen2vl_2b", 16, 8)
    for h in range(2):
        _assert_batches_equal(vl.host_batch_at(1, h, 2),
                              jvl.host_batch_at(1, h, 2))


def _events(inj, steps):
    return [None if e is None else (e.step, e.domains)
            for e in (inj.check(s) for s in range(steps))]


@pytest.mark.parametrize("rate, seed, max_concurrent",
                         [(0.3, 5, 2), (0.1, 0, 3), (0.0, 1, 2)])
def test_injector_events_equal(rate, seed, max_concurrent):
    ours = FailureInjector(num_domains=8, rate_per_step=rate, seed=seed,
                           max_concurrent=max_concurrent)
    theirs = jfailures.FailureInjector(num_domains=8, rate_per_step=rate,
                                       seed=seed,
                                       max_concurrent=max_concurrent)
    got = _events(ours, 200)
    assert got == _events(theirs, 200) == _events(ours, 200)
    if rate:
        assert any(got)
    for e in filter(None, got):
        assert 1 <= len(e[1]) <= max_concurrent
        assert all(0 <= d < 8 for d in e[1])


def test_injector_scheduled_equal():
    ours = FailureInjector(num_domains=8, rate_per_step=0.2, seed=3,
                           scheduled=(FailureEvent(step=7, domains=(2, 3)),))
    theirs = jfailures.FailureInjector(
        num_domains=8, rate_per_step=0.2, seed=3,
        scheduled=(jfailures.FailureEvent(step=7, domains=(2, 3)),))
    assert ours.check(7) == FailureEvent(step=7, domains=(2, 3))
    assert _events(ours, 50) == _events(theirs, 50)


def test_straggler_monitor_equal():
    ours = StragglerMonitor(num_hosts=4, min_steps=3)
    theirs = jfailures.StragglerMonitor(num_hosts=4, min_steps=3)
    rng = np.random.default_rng(0)
    for step in range(8):
        for h in range(4):
            dt = float(rng.uniform(0.9, 1.1)) * (2.5 if h == 2 else 1.0)
            ours.record(h, dt)
            theirs.record(h, dt)
        assert ours.stragglers() == theirs.stragglers()
    assert ours.stragglers() == [2]
    assert np.array_equal(ours.ewma, theirs.ewma)
