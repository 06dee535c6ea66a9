"""The PyTorch port stands alone: importing ``repro_torch`` and every
module of it loads neither JAX nor anything of the JAX package."""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"

_PROBE = """
import importlib, json, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "repro" or m.startswith("repro."))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_imports_no_jax_and_no_jax_package():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["bad"] == []
    # every layer of the slice is there
    for mod in ("repro_torch.kernels.vdb_topk",
                "repro_torch.kernels.flash_attention",
                "repro_torch.kernels.adaln", "repro_torch.kernels.ops",
                "repro_torch.core.cluster_index",
                "repro_torch.runtime.serving", "repro_torch.launch.serve",
                "repro_torch.convert", "repro_torch.core.journal",
                "repro_torch.faults.injector",
                "repro_torch.frontdoor.gateway",
                "repro_torch.launch.frontdoor", "repro_torch.launch.mesh",
                "repro_torch.runtime.partition",
                "repro_torch.configs.registry", "repro_torch.configs.shapes",
                "repro_torch.configs.diffusion_common",
                "repro_torch.configs.flux_dev", "repro_torch.configs.dit_b2",
                "repro_torch.models.diffusion.mmdit",
                "repro_torch.models.diffusion.text_encoder",
                "repro_torch.data.tokenizer", "repro_torch.runtime.steps"):
        assert mod in report["modules"]


def test_no_source_line_imports_jax_or_the_jax_package():
    offending = []
    for path in sorted((SRC / "repro_torch").rglob("*.py")):
        for no, line in enumerate(path.read_text().splitlines(), 1):
            words = line.split()
            if len(words) >= 2 and words[0] in ("import", "from") and (
                    words[1].split(".")[0] in ("jax", "jaxlib", "repro")):
                offending.append(f"{path}:{no}: {line.strip()}")
    assert offending == []
