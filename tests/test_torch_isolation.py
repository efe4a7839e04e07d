"""The PyTorch port stands alone: it imports neither JAX nor the reference.

A fresh interpreter imports every module of `repro_torch`; afterwards no
``jax*`` module and no ``repro`` / ``repro.*`` module may be loaded.  The
package sources must not even spell such an import.
"""
import json
import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"
PKG = SRC / "repro_torch"

_PROBE = r"""
import importlib, json, pathlib, sys
pkg = pathlib.Path(sys.argv[1])
mods = []
for path in sorted(pkg.rglob("*.py")):
    rel = path.relative_to(pkg.parent).with_suffix("")
    parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
    mods.append(".".join(parts))
for name in mods:
    importlib.import_module(name)
loaded = [m for m in sys.modules
          if m == "jax" or m.startswith(("jax.", "jaxlib"))
          or m == "repro" or m.startswith("repro.")]
print(json.dumps({"imported": mods, "forbidden": loaded}))
"""


def test_every_module_imports_without_jax_or_reference():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _PROBE, str(PKG)], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert "repro_torch.fl.simulator" in report["imported"]
    assert "repro_torch.kernels.ops" in report["imported"]
    for mod in ("repro_torch.models.transformer",
                "repro_torch.kernels.rwkv6_scan", "repro_torch.launch.serve",
                "repro_torch.kernels.flash_attention",
                "repro_torch.configs.qwen2_5_3b",
                "repro_torch.core.compression", "repro_torch.core.selection",
                "repro_torch.optim.optimizers",
                "repro_torch.core.convergence", "repro_torch.core.overhead",
                "repro_torch.fl.scenarios", "repro_torch.launch.tracker",
                "repro_torch.launch.serving", "repro_torch.launch.router",
                "repro_torch.checkpoint.checkpoint",
                "repro_torch.launch.train", "repro_torch.data.pipeline",
                "repro_torch.models.moe", "repro_torch.models.ssm",
                "repro_torch.configs.granite_moe_1b_a400m",
                "repro_torch.configs.dbrx_132b",
                "repro_torch.configs.hymba_1_5b",
                "repro_torch.configs.whisper_base",
                "repro_torch.configs.llama3_2_vision_90b",
                "repro_torch.core.dfl_step", "repro_torch.launch.mesh",
                "repro_torch.launch.shardings", "repro_torch.launch.dryrun"):
        assert mod in report["imported"]
    assert report["forbidden"] == []


_QUIET = r"""
import json, os
import torch.distributed as dist
before = dict(os.environ)
import repro_torch.launch.mesh, repro_torch.launch.shardings
import repro_torch.launch.dryrun
print(json.dumps({"group": dist.is_initialized(),
                  "env": sorted(k for k in set(os.environ) | set(before)
                                if os.environ.get(k) != before.get(k))}))
"""


def test_dry_run_modules_import_quietly():
    """Importing the dry run and the production mesh starts no process
    group (the fake one is made by `make_production_mesh`, when called)
    and sets no environment variable (the reference's dry run sets
    XLA_FLAGS on import)."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _QUIET], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report == {"group": False, "env": []}


def test_sources_spell_no_jax_or_reference_import():
    sources = sorted(PKG.rglob("*.py"))
    assert len(sources) >= 15
    for path in sources:
        text = path.read_text(encoding="utf-8")
        for needle in ("import jax", "from jax", "from repro",
                       "import repro"):
            assert needle not in text, f"{path}: {needle!r}"
