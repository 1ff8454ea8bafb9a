"""``--profile_dir`` and the throughput counter (kgc_gcn_torch/utils/
profiling.py, train/loop.py, cli.py) against the JAX package's
(``kgc_gcn_tpu/utils/profiling.py``, ``train/loop.py:309-383``).

``StepTimer`` gives the JAX package's numbers over one ``update``/``add``
sequence on one scripted clock; ``trace`` writes one compressed trace of
at most its ``steps`` steps; ``train_and_evaluate`` traces the profiled
epoch (its first ``TRACE_STEPS`` steps) and leaves it out
of ``steps_per_s`` as the JAX loop does (records compared with the JAX
loop's on one scripted trainer); a 3-epoch Toy CLI run with
``--profile_dir`` writes the trace of epoch 2.
"""

import contextlib
import gzip
import json
import logging
import os
import types

import pytest
import torch

import kgc_gcn_tpu.utils.profiling as jprof
from kgc_gcn_tpu.config import Config as JaxConfig
from kgc_gcn_tpu.train import loop as jloop

from kgc_gcn_torch import cli
from kgc_gcn_torch.config import Config
from kgc_gcn_torch.data.toy import write_toy
from kgc_gcn_torch.train import loop as ploop
from kgc_gcn_torch.utils import profiling as pprof


def test_step_timer_matches_jax(monkeypatch):
    timers = []
    for mod in (jprof, pprof):
        ticks = iter([10.0, 10.5, 11.25, 13.0])
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(ticks))
        t = mod.StepTimer(edges_per_step=3000, n_chips=2)
        assert t.steps_per_s == 0.0
        t.update()            # the first interval is excluded
        t.update(4)
        t.add(0.75, 2)
        t.update(1)
        t.update(8)
        timers.append(t)
    jt, pt = timers
    assert (pt.steps, pt.seconds) == (jt.steps, jt.seconds) == (15, 3.75)
    assert pt.steps_per_s == jt.steps_per_s
    assert pt.edges_per_s_per_chip == jt.edges_per_s_per_chip
    assert pt.report() == jt.report()


def test_trace_writes_one_compressed_trace(tmp_path):
    with pprof.trace(str(tmp_path)):
        with pprof.annotate("kgc_span"):
            torch.ones(8, 8).sum()
    (name,) = os.listdir(tmp_path)
    assert name.endswith(".pt.trace.json.gz")
    with gzip.open(tmp_path / name, "rt") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "kgc_span" for e in events)


def test_trace_records_its_first_steps_only(tmp_path):
    """Stepped past its bound, the trace holds the first ``steps`` steps'
    spans and no later one."""
    with pprof.trace(str(tmp_path), steps=2) as prof:
        for i in range(5):
            with pprof.annotate(f"kgc_step_{i}"):
                torch.ones(8, 8).sum()
            prof.step()
    (name,) = os.listdir(tmp_path)
    with gzip.open(tmp_path / name, "rt") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {n for n in names if n and n.startswith("kgc_step_")} == {
        "kgc_step_0", "kgc_step_1"}


class _Scripted:
    """A trainer whose epochs and validation follow a script (both
    packages' ``train_and_evaluate`` read only these members)."""

    def __init__(self, cfg):
        self.cfg, self.epoch = cfg, 0
        self.graph = type("G", (), {"num_messages": 10})()
        self.steps_per_epoch, self.mesh = 3, None
        self.generator = torch.Generator()
        self.model = self.opt_state = None

    def train_epoch(self, *args, **kwargs):
        self.epoch += 1
        return (*args[:3], 1.0) if len(args) > 3 else 1.0

    def evaluate(self, *args, **kwargs):
        return {"mr": 2.0, "mrr": 0.1 * self.epoch, "hits@1": 0.0,
                "hits@3": 0.0, "hits@10": 0.5}


@pytest.mark.parametrize("profile_epoch", [2, 3])
def test_the_traced_epoch_is_left_out_as_in_jax(tmp_path, monkeypatch,
                                                profile_epoch):
    traced = {"jax": [], "port": []}

    def fake(key):
        @contextlib.contextmanager
        def trace(logdir):
            traced[key].append(logdir)
            yield types.SimpleNamespace(step=lambda: None)
        return trace

    monkeypatch.setattr(jprof, "trace", fake("jax"))
    monkeypatch.setattr(ploop, "trace", fake("port"))
    monkeypatch.setattr(jloop, "save_checkpoint", lambda *a: None)
    monkeypatch.setattr(ploop, "save_checkpoint", lambda *a: None)
    kw = dict(max_epoch=4, eval_every=2)
    recs = {}
    for key, run in (
            ("jax", lambda d: jloop.train_and_evaluate(
                _Scripted(JaxConfig(**kw)), None, None, None, d,
                profile_dir="T", profile_epoch=profile_epoch)),
            ("port", lambda d: ploop.train_and_evaluate(
                _Scripted(Config(**kw)), d, profile_dir="T",
                profile_epoch=profile_epoch))):
        (tmp_path / key).mkdir()
        run(str(tmp_path / key))
        with open(tmp_path / key / "metrics.jsonl") as f:
            recs[key] = [json.loads(line) for line in f]
    assert traced == {"jax": ["T"], "port": ["T"]}
    keys = lambda rs: [sorted(k for k in r if k != "sec") for r in rs]
    assert keys(recs["port"]) == keys(recs["jax"])
    timed = [r["epoch"] for r in recs["port"] if "steps_per_s" in r]
    assert timed == [e for e in (2, 3, 4) if e != profile_epoch]


def test_cli_traces_epoch_2_and_leaves_it_out(tmp_path, caplog):
    write_toy(str(tmp_path / "data"))
    prof = tmp_path / "prof"
    with caplog.at_level(logging.INFO):
        assert cli.main([
            "--dataset", "Toy", "--data_dir", str(tmp_path / "data"),
            "--experiments_dir", str(tmp_path / "exp"), "--device", "cpu",
            "--do_train", "--max_epoch", "3", "--batch_size", "64",
            "--gcn_in_dim", "8", "--gcn_out_dim", "16", "--k_w", "4",
            "--k_h", "4", "--num_filter", "4", "--kernel_size", "3",
            "--profile_dir", str(prof)]) == 0
    (name,) = os.listdir(prof)
    assert name.endswith(".pt.trace.json.gz") and (prof / name).stat().st_size
    with gzip.open(prof / name, "rt") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::index_add_" in names          # K1's plain version ran
    assert any(f"Captured device trace of epoch 2 -> {prof}" in r.getMessage()
               for r in caplog.records)
    with open(tmp_path / "exp" / "Toy" / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f][1:]
    assert [("steps_per_s" in r) for r in recs] == [False, False, True]
