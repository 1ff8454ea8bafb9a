"""Nothing the benchmark runs imports JAX, Flax, the JAX package or its TPU
scripts; the reference imports nothing of the port."""

from conftest import BENCH

from benchmark.lib import isolation


def test_no_forbidden_import_under_the_benchmark():
    assert isolation.forbidden_imports(BENCH) == []


def test_reference_imports_nothing_of_the_port():
    for path in sorted((BENCH / "reference").glob("*.py")):
        mods = isolation.imports_of(path)
        assert not [m for m in mods if isolation.top_level(m) == "kgc_gcn_torch"], path


def test_names_compare_whole():
    loaded = ["kgc_gcn_torch", "kgc_gcn_torch.ops", "benchmark.lib",
              "jaxtyping", "benchmarks", "torch"]
    assert isolation.loaded_forbidden(loaded) == []
    for bad in ("jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
                "kgc_gcn_tpu", "kgc_gcn_tpu.ops", "bench", "chip_smoke"):
        assert isolation.loaded_forbidden(loaded + [bad]) == [bad]
