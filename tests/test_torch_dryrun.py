"""PyTorch port vs the JAX reference: `launch.dryrun` and the production
mesh of `launch.mesh` (CPU).

* Exact parity: `input_specs` and `decode_plan` for every config x input
  shape (shapes and dtypes), `_wire_factor` for every kind and group
  size, `model_flops` for every config, training and inference (rel
  1e-12), and the collective-bytes sum over records equal to
  tests/test_dryrun_utils.py's four HLO lines against the reference's
  parser of those lines.
* Over the fake process group, in subprocesses (the fake default group is
  process-global and dies with them): the production meshes' shapes and
  axis names; `shardings.to_placements` for a ('pod', 'data') dim, its
  local shard shape and, with rank 0 placed at pod 1 / data 3, its row
  offset (pod major, data minor, as GSPMD splits it); a (256, 4096) @
  (4096, 4096) product sharded rows over 'data' and columns over 'model'
  counted at 1/256 of its global FLOPs; the layer-extrapolated costs of a
  4-layer smoke config equal to the direct count; a real default group is
  never replaced.
* One `run_one` per family (dense, moe, ssm, hybrid, enc_dec, vlm) on the
  16 x 16 mesh, each config's smoke variant at long_500k: ok, the
  reference's key set (and the port's one diagnostic key), a useful-FLOPs
  ratio above 0; and the CLI on one full config, exit 0 and its JSON.
"""
import functools
import json
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_parity  # noqa: E402  (caps torch's CPU threads)
from repro.configs import base as jbase  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"
ARCHS = base.ARCH_IDS
DTYPES = {jnp.int32: torch.int32, jnp.bfloat16: torch.bfloat16,
          jnp.float32: torch.float32}
# The keys of the reference's run_one result (launch/dryrun.py: run_one)
# and of what its main adds to a successful one.
REFERENCE_KEYS = {
    "arch", "shape", "mesh", "family", "kind", "ok", "compile_s",
    "cost_extrapolation_s", "n_chips", "hlo_flops", "hlo_bytes",
    "collective_bytes", "collectives", "compute_term_s", "memory_term_s",
    "collective_term_s", "dominant", "model_flops", "useful_flops_ratio",
    "bytes_per_device"}
MAIN_KEYS = {"profile", "overrides"}
BYTES_KEYS = {"output", "temp", "argument", "generated_code"}
FAMILIES = {"dense": "qwen2_5_3b", "moe": "granite_moe_1b_a400m",
            "ssm": "rwkv6_1_6b", "hybrid": "hymba_1_5b",
            "enc_dec": "whisper_base", "vlm": "llama3_2_vision_90b"}


@functools.lru_cache(maxsize=None)
def reference():
    return _torch_parity.reference_dryrun()


def _shape_dtypes(tree):
    if isinstance(tree, dict):
        return {k: _shape_dtypes(v) for k, v in tree.items()}
    dtype = tree.dtype
    return (tuple(tree.shape), DTYPES.get(dtype, dtype) if not isinstance(
        dtype, torch.dtype) else dtype)


@pytest.mark.parametrize("shape_name", list(base.INPUT_SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_and_decode_plan_match_reference(arch, shape_name):
    jd = reference()
    jcfg, cfg = jbase.get(arch), base.get(arch)
    jshape, shape = (jbase.INPUT_SHAPES[shape_name],
                     base.INPUT_SHAPES[shape_name])
    want = jax.tree.map(lambda s: (tuple(s.shape), DTYPES[s.dtype.type]),
                        jd.input_specs(jcfg, jshape))
    got = _shape_dtypes(dryrun.input_specs(cfg, shape))
    assert got == want
    if shape.kind == "decode":
        assert dryrun.decode_plan(cfg, shape) == jd.decode_plan(jcfg, jshape)


def test_wire_factor_matches_reference():
    jd = reference()
    for kind in ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                 "collective-permute"):
        for g in (0, 1, 2, 3, 8, 16, 32, 512):
            assert dryrun._wire_factor(kind, g) == jd._wire_factor(kind, g)


def test_collective_bytes_match_reference_parser():
    jd = reference()
    hlo = """
  %ag = bf16[8,4096,2048]{2,1,0} all-gather(%x), replica_groups={{0,1,2,3}}, dimensions={0}
  %ar = f32[1024]{0} all-reduce(%y), replica_groups={{0,1},{2,3}}, to_apply=%add
  %rs = f32[256,128]{1,0} reduce-scatter(%z), replica_groups=[4,8]<=[32], dimensions={0}
  %a2a = bf16[16,64]{1,0} all-to-all(%w), replica_groups={{0,1,2,3,4,5,6,7}}
  %done = f32[4]{0} all-reduce-done(%ar)
"""
    records = [
        dryrun.Collective("all-gather", (8, 4096, 2048), torch.bfloat16, 4),
        dryrun.Collective("all-reduce", (1024,), torch.float32, 2),
        dryrun.Collective("reduce-scatter", (256, 128), torch.float32, 8),
        dryrun.Collective("all-to-all", (16, 64), torch.bfloat16, 8)]
    assert dryrun.collective_bytes(records) == jd.collective_bytes(hlo)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_match_reference(arch):
    jd = reference()
    for train in (True, False):
        for n_tokens in (1.0, 256 * 4096):
            want = jd.model_flops(jbase.get(arch), n_tokens, train=train)
            got = dryrun.model_flops(base.get(arch), n_tokens, train=train)
            assert got == pytest.approx(want, rel=1e-12, abs=0)


_PROBE = r"""
import dataclasses, json, sys
import torch
import torch.distributed as dist
from repro_torch.configs import base
from repro_torch.launch import dryrun, mesh as meshlib, shardings

out = {}
part = sys.argv[1]
if part == "mesh":
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    from torch.distributed.tensor.experimental import implicit_replication

    m1 = meshlib.make_production_mesh()
    out["single"] = [list(m1.mesh.shape), list(m1.mesh_dim_names),
                     dist.get_world_size(), dist.get_backend()]
    m2 = meshlib.make_production_mesh(multi_pod=True)
    out["multi"] = [list(m2.mesh.shape), list(m2.mesh_dim_names),
                    dist.get_world_size()]
    out["data_axes"] = [list(meshlib.data_axes()),
                        list(meshlib.data_axes(multi_pod=True))]
    spec = shardings.P(("pod", "data"), "model")
    pl = shardings.to_placements(m2, spec)
    out["placements"] = [str(p) for p in pl]
    t = dryrun._fake_dtensor(torch._subclasses.fake_tensor.FakeTensorMode(),
                             m2, (64 * 32, 48), torch.float32, spec)
    out["local"] = list(t.to_local().shape)
    # rank 0 placed at (pod 1, data 3, model 5)
    ranks = torch.arange(512).reshape(2, 16, 16)
    ranks[0, 0, 0], ranks[1, 3, 5] = ranks[1, 3, 5].clone(), 0
    moved = DeviceMesh("cpu", ranks, mesh_dim_names=("pod", "data", "model"),
                       _init_backend=False)
    shape, offset = compute_local_shape_and_global_offset(
        (64 * 32, 48), moved, shardings.to_placements(moved, spec))
    out["at_1_3_5"] = [list(shape), list(offset)]
    try:
        shardings.to_placements(m2, shardings.P(("data", "pod")))
        out["reversed"] = None
    except ValueError as e:
        out["reversed"] = str(e)
    # an evenly sharded product: local FLOPs = global / 256
    m1 = meshlib.make_production_mesh()
    fake = torch._subclasses.fake_tensor.FakeTensorMode(
        allow_non_fake_inputs=True)
    a = dryrun._fake_dtensor(fake, m1, (256, 4096), torch.bfloat16,
                             shardings.P("data", None))
    w = dryrun._fake_dtensor(fake, m1, (4096, 4096), torch.bfloat16,
                             shardings.P(None, "model"))
    trace = dryrun._Trace(fake, m1)
    with implicit_replication(), dryrun._make_mode()(trace):
        c = a @ w
    out["matmul"] = [trace.flops, 2.0 * 256 * 4096 * 4096,
                     [str(p) for p in c.placements], list(c.to_local().shape)]
    # layer extrapolation = the direct count (4 units of a smoke config)
    shape = base.InputShape("smoke_decode", 64, 32, "decode")
    cfg = dataclasses.replace(base.smoke_variant(base.get("qwen2_5_3b")),
                              n_layers=4)
    x = dryrun.extrapolated_costs(cfg, shape, m1, ("data",), 256)
    d = dryrun._extract_costs(
        dryrun._trace(cfg, shape, m1, ("data",), 256)[0])
    out["extrapolated"] = [[x[k], d[k]] for k in ("flops", "bytes", "coll")]
    out["by_kind"] = [x["coll_by_kind"], d["coll_by_kind"]]
elif part == "family":
    for fam, arch in json.loads(sys.argv[2]).items():
        cfg = base.smoke_variant(base.get(arch))
        out[fam] = dryrun.run_one(arch, "long_500k", multi_pod=False,
                                  cfg_override=cfg)
elif part == "real_group":
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        meshlib.make_production_mesh()
        out["error"] = None
    except RuntimeError as e:
        out["error"] = str(e)
    out["backend"] = dist.get_backend()
print(json.dumps(out))
"""


def _probe(*args, timeout: float = 300.0) -> dict:
    env = dict(os.environ, PYTHONPATH=str(SRC))
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", _PROBE, *args], env=env,
                         capture_output=True, text=True, timeout=timeout)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@functools.lru_cache(maxsize=None)
def mesh_probe() -> dict:
    return _probe("mesh")


@functools.lru_cache(maxsize=None)
def family_probe() -> dict:
    return _probe("family", json.dumps(FAMILIES))


def test_production_meshes():
    out = mesh_probe()
    assert out["single"] == [[16, 16], ["data", "model"], 256, "fake"]
    assert out["multi"] == [[2, 16, 16], ["pod", "data", "model"], 512]
    assert out["data_axes"] == [["data"], ["pod", "data"]]


def test_placements_of_a_pod_data_dim():
    out = mesh_probe()
    assert out["placements"] == ["S(0)", "S(0)", "S(1)"] or out[
        "placements"] == ["Shard(dim=0)", "Shard(dim=0)", "Shard(dim=1)"]
    assert out["local"] == [64, 3]
    # pod 1, data 3: shard 1 * 16 + 3 of 32 along rows; model 5 of 16 cols
    assert out["at_1_3_5"] == [[64, 3], [(16 + 3) * 64, 5 * 3]]
    assert "orders its axes unlike the mesh" in out["reversed"]


def test_sharded_matmul_counts_local_flops():
    local, global_, placements, shape = mesh_probe()["matmul"]
    assert local == global_ / 256
    assert shape == [16, 256]


def test_extrapolation_equals_direct_count():
    out = mesh_probe()
    for extrapolated, direct in out["extrapolated"]:
        assert extrapolated == direct and direct > 0
    assert out["by_kind"][0] == out["by_kind"][1]


def test_real_group_is_never_replaced():
    out = _probe("real_group")
    assert "will not replace it" in out["error"]
    assert out["backend"] == "gloo"


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_run_one_per_family(family):
    res = family_probe()[family]
    assert res["ok"] is True
    assert res["family"] == family and res["kind"] == "decode"
    assert set(res) == REFERENCE_KEYS | {"replicated_ops"}
    assert set(res["bytes_per_device"]) == BYTES_KEYS
    assert res["n_chips"] == 256 and res["mesh"] == "16x16"
    assert res["useful_flops_ratio"] > 0
    assert res["dominant"] in ("compute", "memory", "collective")
    assert res["bytes_per_device"]["argument"] > 0
    assert res["bytes_per_device"]["generated_code"] is None


def test_cli_writes_reference_keys(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    env.pop("XLA_FLAGS", None)
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "rwkv6-1.6b", "--shape", "long_500k", "--out", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "done: 1/1 ok" in res.stdout
    (path,) = tmp_path.glob("*.json")
    assert path.name == "rwkv6-1.6b__long_500k__16x16.json"
    out = json.loads(path.read_text())
    assert set(out) == REFERENCE_KEYS | MAIN_KEYS | {"replicated_ops"}
    assert out["ok"] and out["useful_flops_ratio"] > 0
