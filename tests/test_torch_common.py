"""Shared helpers of the kgc_gcn_torch parity tests, and the tests of the
pieces every other port test leans on: the config copy and the JAX leaf map
(kgc_gcn_torch/config.py, kgc_gcn_torch/convert.py).

The other ``test_torch_*.py`` files import the helpers from here.  JAX stays
on the CPU (tests/conftest.py); data crosses between the packages as numpy.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kgc_gcn_tpu.config import dataset_preset as jax_preset
from kgc_gcn_tpu.models import build_model as jax_build_model
from kgc_gcn_tpu.models.common import BNParams, BNState

from kgc_gcn_torch.config import Config, dataset_preset
from kgc_gcn_torch.convert import jax_leaf_names, params_from_numpy
from kgc_gcn_torch.data.batching import make_banks
from kgc_gcn_torch.data.dataset import build_dataset
from kgc_gcn_torch.data.graph import build_graph
from kgc_gcn_torch.data.toy import toy_triples
from kgc_gcn_torch.models import build_model

# The port's tests run on toy shapes, where torch's intra-op threads cost
# more than they save, and several test processes share the machine's cores
# (pytest-xdist workers, JAX's own threads): one thread per process.  Every
# worker imports this module while it collects the port's test files.
torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def port_toy():
    """The port's (dataset, graph, banks) for the triples of the ``toy``
    fixture of tests/conftest.py, on the CPU."""
    train, valid, test = toy_triples(n_ent=12, n_rel=4, n_train=40)
    ds = build_dataset("toy", train, valid, test)
    graph = build_graph(ds.train_triples, ds.num_entity, ds.num_relation,
                        pad_to=8)
    return ds, graph, make_banks(ds)


def port_cfg(jax_cfg) -> Config:
    return Config(**dataclasses.asdict(jax_cfg))


def jax_leaves(tree) -> dict:
    """{dotted JAX path: numpy array} of a params or state pytree (a list
    entry's index is a path component: ``layers.0.basis``)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    key = lambda k: str(getattr(k, "name", getattr(k, "idx", k)))
    return {".".join(key(k) for k in path): np.asarray(v) for path, v in flat}


def randomize(params, state, rng):
    """Give every BN layer non-trivial scale/bias/running stats and the
    entity bias non-zero values, so eval BN is no identity."""

    def walk(node, fn, cls):
        if isinstance(node, cls):
            return fn(node)
        if dataclasses.is_dataclass(node):
            return type(node)(**{f.name: walk(getattr(node, f.name), fn, cls)
                                 for f in dataclasses.fields(node)})
        return node

    f32 = lambda a: jnp.asarray(a, jnp.float32)
    params = walk(params, lambda p: BNParams(
        scale=f32(rng.uniform(0.5, 1.5, p.scale.shape)),
        bias=f32(rng.normal(0, 0.3, p.bias.shape))), BNParams)
    state = walk(state, lambda s: BNState(
        mean=f32(rng.normal(0, 0.3, s.mean.shape)),
        var=f32(rng.uniform(0.5, 2.0, s.var.shape))), BNState)
    dec = dataclasses.replace(params.decoder, ent_bias=f32(
        rng.normal(0, 0.1, params.decoder.ent_bias.shape)))
    return dataclasses.replace(params, decoder=dec), state


def rgcn_cfg(toy_cfg, **kw):
    """A toy R-GCN + DistMult config (d_in 8, d_out 16, B 3), dropout off."""
    base = dict(model="rgcn", decoder="distmult", num_bases=3, gcn_in_dim=8,
                gcn_out_dim=16, gcn_drop=0.0, batch_size=8, num_negatives=5)
    return toy_cfg.replace(**{**base, **kw})


def rgat_cfg(toy_cfg, **kw):
    """A toy RGAT + DistMult config (d_in 8, d_out 16, H 4), dropout off."""
    base = dict(model="rgat", decoder="distmult", num_heads=4, gcn_in_dim=8,
                gcn_out_dim=16, gcn_drop=0.0, batch_size=8, num_negatives=5)
    return toy_cfg.replace(**{**base, **kw})


def randomize_rel_bias(params, rng):
    """RGAT's per-relation attention bias starts at zero in the JAX init;
    give every layer's a non-zero value, so that its gradient is tested."""
    f32 = lambda a: jnp.asarray(a, jnp.float32)
    return dataclasses.replace(params, layers=[
        dataclasses.replace(lay, rel_bias=f32(rng.normal(0, 0.5,
                                                         lay.rel_bias.shape)))
        for lay in params.layers])


def jax_and_port_models(toy, cfg, seed: int = 0):
    """A JAX model (MGCN, RGCN or RGAT, by ``cfg.model``) with randomized
    weights, BN stats, entity bias and RGAT attention bias, and the port's
    model holding the same weights carried across by
    convert.params_from_numpy."""
    ds, graph, _ = toy
    model = jax_build_model(cfg, ds.num_entity, ds.num_relation, ds.num_edge,
                            e_pad=graph.e_pad)
    params, state = model.init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    params, state = randomize(params, state, rng)
    if cfg.model == "rgat":
        params = randomize_rel_bias(params, rng)
    port = build_model(port_cfg(cfg), ds.num_entity, ds.num_relation,
                       ds.num_edge, e_pad=graph.e_pad)
    port.load_state_dict(params_from_numpy(jax_leaves(params),
                                           jax_leaves(state)))
    return model, params, state, port.eval()


# ---------------------------------------------------------------------- tests

def test_config_fields_and_presets_match_jax():
    import kgc_gcn_tpu.config as jc
    import kgc_gcn_torch.config as pc
    assert ([(f.name, f.default) for f in dataclasses.fields(jc.Config)]
            == [(f.name, f.default) for f in dataclasses.fields(pc.Config)])
    assert jc._PRESETS == pc._PRESETS
    for name in ("WN18RR", "FB15k-237", "Toy", "other"):
        assert (dataclasses.asdict(jax_preset(name))
                == dataclasses.asdict(dataset_preset(name)))


def test_params_json_round_trip_between_packages(tmp_path):
    from kgc_gcn_tpu.config import Config as JaxConfig
    cfg = dataset_preset("FB15k-237", gcn_in_dim=64, bias=True)
    cfg.to_json(str(tmp_path / "params.json"))
    back = JaxConfig.from_json(str(tmp_path / "params.json"))
    assert dataclasses.asdict(back) == dataclasses.asdict(cfg)
    assert Config.from_json(str(tmp_path / "params.json")) == cfg


@pytest.mark.parametrize("bias", [False, True])
def test_jax_leaf_names_pin_the_flatten_order(toy, toy_cfg, bias):
    """convert.jax_leaf_names lists the JAX leaves in tree_flatten order,
    and every one maps onto a port state-dict entry of the same shape."""
    cfg = toy_cfg.replace(bias=bias)
    ds, graph, _ = toy
    model = jax_build_model(cfg, ds.num_entity, ds.num_relation, ds.num_edge,
                            e_pad=graph.e_pad)
    params, state = model.init(jax.random.PRNGKey(0))
    p_names, s_names = jax_leaf_names(port_cfg(cfg))
    assert list(jax_leaves(params)) == p_names
    assert list(jax_leaves(state)) == s_names
    assert len(p_names) == 21 + bias and len(s_names) == 8

    port = build_model(port_cfg(cfg), ds.num_entity, ds.num_relation,
                       ds.num_edge, e_pad=graph.e_pad)
    sd = params_from_numpy(jax_leaves(params), jax_leaves(state))
    assert sorted(sd) == sorted(port.state_dict())
    for k, v in port.state_dict().items():
        assert tuple(sd[k].shape) == tuple(v.shape), k


def test_resolve_device_pins_float32_and_refuses_a_missing_card():
    from kgc_gcn_torch.utils.device import resolve_device
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    assert resolve_device("cpu") == torch.device("cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device("cuda")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")
