"""``metrics/host_reads_per_pass.eval.py`` on the toy evaluation cell, run
in process on the CPU: each pass reads each query batch's metric sums once;
a count the passes do not divide, or a program without the counter, reads
nothing."""

import json

from benchmark.lib import cells
from kgc_gcn_torch.utils import profiling

SEED = 2**31 + 29
CELL = "mgcn_conve_toy.eval.toy"


def test_reads_a_pass(run_module, toy_bench, monkeypatch):
    monkeypatch.setattr(profiling, "host_reads", 0)
    c = cells.cell(CELL, toy_bench)
    ctx = run_module.run_cell(c, SEED, 0.2, True, "cpu")["context"]
    reader = c.reader("host_reads_per_pass.eval")
    queries = json.loads((toy_bench / "traffic" / "eval.toy.json")
                         .read_text())["counts"]["test"]
    assert reader.read(ctx) == 2 * -(-queries // 16)     # eval batch 16
    monkeypatch.setattr(profiling, "host_reads", profiling.host_reads + 1)
    assert reader.read(ctx) is None
    monkeypatch.delattr(profiling, "host_reads")
    assert reader.read(ctx) is None
