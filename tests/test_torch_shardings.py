"""PyTorch port vs the JAX reference: `launch.shardings` (CPU).

The port's `param_specs` / `batch_specs` / `cache_specs` over its flat
dotted trees against the reference's over its nested ones, leaf for leaf
(dotted names, every spec entry, the ones `_fit` drops included):

* `param_specs` for every full config x both profiles x both data axes
  ('data' and ('pod', 'data')), on the parameters and on the AdamW state
  ({"step", "m", "v"}).  The reference's trees come from `jax.eval_shape`,
  the port's from `init_params` / `optimizer.init` under `FakeTensorMode`
  (nothing allocated).
* `batch_specs` for each input shape's batch (modal embeddings included)
  x shard_batch, and `cache_specs` for decode_32k and long_500k x both
  ``kv_shard`` x both ``shard_batch``, every config.
* `to_placements` needs a `DeviceMesh`: tests/test_torch_dryrun.py checks
  it in a subprocess over the production mesh.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

import _torch_parity  # noqa: E402  (caps torch's CPU threads)
from repro.configs import base as jbase  # noqa: E402
from repro.launch import shardings as jshard  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.launch import dryrun, shardings  # noqa: E402
from repro_torch.models import registry, transformer  # noqa: E402

ARCHS = base.ARCH_IDS
DATA_AXES = {"data": "data", "pod_data": ("pod", "data")}


def _entry(e):
    """A spec entry in one form: a 1-tuple of axes is its axis."""
    if isinstance(e, (tuple, list)):
        return e[0] if len(e) == 1 else tuple(e)
    return e


def _spec(p) -> tuple:
    return tuple(_entry(e) for e in p)


def jax_specs(tree) -> dict:
    """Dotted leaf name -> spec entries of a reference spec tree."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    return {".".join(str(k.key) for k in path): _spec(p)
            for path, p in leaves}


def port_specs(tree, prefix: str = "") -> dict:
    """Dotted leaf name -> spec entries of a port spec tree."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(port_specs(v, f"{prefix}.{k}" if prefix else k))
        return out
    assert isinstance(tree, shardings.PartitionSpec)
    return {prefix: _spec(tree)}


@functools.lru_cache(maxsize=None)
def reference_trees(arch: str):
    """The reference's (params, AdamW state) shape trees."""
    bundle = jregistry.build(jbase.get(arch))
    params = jax.eval_shape(bundle.init, jax.random.PRNGKey(0))
    return params, jax.eval_shape(bundle.optimizer.init, params)


@functools.lru_cache(maxsize=None)
def port_trees(arch: str):
    """The port's (params, AdamW state) as fake tensors."""
    cfg = base.get(arch)
    with FakeTensorMode():
        params = transformer.init_params(torch.Generator().manual_seed(0),
                                         cfg)
        opt = registry.build(cfg).optimizer.init(params)
    return params, opt


@pytest.mark.parametrize("profile", ["fsdp", "tp_only"])
@pytest.mark.parametrize("dax", sorted(DATA_AXES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, dax, profile):
    jparams, jopt = reference_trees(arch)
    params, opt = port_trees(arch)
    axes = DATA_AXES[dax]
    for jtree, tree in ((jparams, params), (jopt, opt)):
        want = jax_specs(jshard.param_specs(jtree, data_axes=axes,
                                            profile=profile))
        got = port_specs(shardings.param_specs(tree, data_axes=axes,
                                               profile=profile))
        assert got == want
    assert list(got)[1:] == [k for k in want if k != "step"]  # leaf order
    # _fit drops a split that does not divide: whisper's vocabulary of
    # 51,865 stays whole over 16 model shards.
    if arch == "whisper_base":
        table = port_specs(shardings.param_specs(
            params, data_axes=axes, profile=profile))["embed.table"]
        assert table[0] is None


@pytest.mark.parametrize("dax", sorted(DATA_AXES))
@pytest.mark.parametrize("shape_name", list(base.INPUT_SHAPES))
def test_batch_specs_match_reference(shape_name, dax):
    jdryrun = _torch_parity.reference_dryrun()
    axes = DATA_AXES[dax]
    for arch in ARCHS:
        jspecs = jdryrun.input_specs(jbase.get(arch),
                                     jbase.INPUT_SHAPES[shape_name])
        specs = dryrun.input_specs(base.get(arch),
                                   base.INPUT_SHAPES[shape_name])
        key = "batch" if "batch" in specs else None
        jtree = jspecs[key] if key else {"token": jspecs["token"]}
        tree = specs[key] if key else {"token": specs["token"]}
        for shard_batch in (True, False):
            want = jax_specs(jshard.batch_specs(
                jtree, data_axes=axes, shard_batch=shard_batch))
            got = port_specs(shardings.batch_specs(
                tree, data_axes=axes, shard_batch=shard_batch))
            assert got == want, (arch, shard_batch)


@pytest.mark.parametrize("kv_shard", ["heads", "seq"])
@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
def test_cache_specs_match_reference(shape_name, kv_shard):
    shape = base.INPUT_SHAPES[shape_name]
    for arch in ARCHS:
        cfg = base.get(arch)
        cache_len, window, _ = dryrun.decode_plan(cfg, shape)
        b = shape.global_batch
        jbundle = jregistry.build(jbase.get(arch))
        jcache = jax.eval_shape(
            lambda: jbundle.init_cache(b, cache_len, window=window))
        with FakeTensorMode():
            cache = transformer.init_cache(cfg, b, cache_len, window=window,
                                           device="cpu")
        for dax, axes in DATA_AXES.items():
            for shard_batch in (True, False):
                want = jax_specs(jshard.cache_specs(
                    jcache, data_axes=axes, shard_batch=shard_batch,
                    kv_shard=kv_shard))
                got = port_specs(shardings.cache_specs(
                    cache, data_axes=axes, shard_batch=shard_batch,
                    kv_shard=kv_shard))
                assert got == want, (arch, dax, shard_batch)


def test_spec_entries_and_fit():
    p = shardings.P(("pod", "data"), None, "model")
    assert p == (("pod", "data"), None, "model") and repr(p).startswith("P")
    assert shardings._axis_prod(("pod", "data")) == 32
    assert shardings._fit([("pod", "data"), "model"], (64, 51865)) == (
        ("pod", "data"), None)
    assert shardings._fit(["model", None], (8, 3)) == (None, None)
