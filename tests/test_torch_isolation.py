"""The port stands alone: importing it pulls in neither JAX nor the
reference package, ``chip_smoke.py`` imports neither, and the entry
points run on the card unless told otherwise."""
import ast
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"


def _port_modules() -> list[str]:
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        parts = path.relative_to(PORT.parent).with_suffix("").parts
        mods.append(".".join(parts[:-1] if parts[-1] == "__init__"
                             else parts))
    return mods


def _is_forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top == "repro" or top == "jax" or top.startswith("jax")


def test_port_modules_cover_the_slice():
    mods = set(_port_modules())
    for m in ("repro_torch.api", "repro_torch.convert",
              "repro_torch.core.engine", "repro_torch.core.backends",
              "repro_torch.kernels.smm_conv.ops",
              "repro_torch.kernels.smm_conv.ref", "repro_torch.kernels._build",
              "repro_torch.kernels.flash_attention.ops",
              "repro_torch.kernels.flash_attention.ref",
              "repro_torch.configs.paper_cnns",
              "repro_torch.core.cost_model", "repro_torch.core.serving",
              "repro_torch.core.batching", "repro_torch.models.cache",
              "repro_torch.runtime", "repro_torch.runtime.resilience",
              "repro_torch.launch.serve", "repro_torch.models.lm",
              "repro_torch.checkpoint", "repro_torch.checkpoint.packed",
              "repro_torch.models.attention", "repro_torch.models.moe",
              "repro_torch.configs.deepseek_v2_236b",
              "repro_torch.configs.granite_moe_1b",
              "repro_torch.configs.qwen1_5_4b",
              "repro_torch.configs.qwen3_32b",
              "repro_torch.configs.command_r_plus_104b",
              "repro_torch.tune", "repro_torch.tune.plan",
              "repro_torch.tune.autotune", "repro_torch.tune.eval",
              "repro_torch.launch.tune", "repro_torch.models.ssm",
              "repro_torch.models.encdec", "repro_torch.configs.xlstm_350m",
              "repro_torch.configs.jamba_v01_52b",
              "repro_torch.configs.internvl2_26b",
              "repro_torch.configs.seamless_m4t_medium",
              "repro_torch.sharding", "repro_torch.sharding.rules",
              "repro_torch.runtime.straggler", "repro_torch.runtime.elastic",
              "repro_torch.runtime.loop", "repro_torch.optim",
              "repro_torch.optim.adamw", "repro_torch.optim.schedule",
              "repro_torch.data", "repro_torch.data.pipeline",
              "repro_torch.checkpoint.manager", "repro_torch.launch.train",
              "repro_torch.launch.mesh", "repro_torch.launch.steps",
              "repro_torch.launch.dryrun"):
        assert m in mods


def test_importing_the_port_loads_no_jax_and_no_reference():
    code = (
        "import importlib, json, sys\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "repro_torch.core.engine" in loaded
    bad = [m for m in loaded if _is_forbidden(m)]
    assert not bad, f"the port pulled in {bad}"


@pytest.mark.parametrize("path", ["chip_smoke.py", *[
    str(p.relative_to(ROOT)) for p in sorted(PORT.rglob("*.py"))]])
def test_sources_import_neither_jax_nor_the_reference(path):
    tree = ast.parse((ROOT / path).read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            names.append(node.module)
    bad = [n for n in names if _is_forbidden(n)]
    assert not bad, f"{path} imports {bad}"


def test_compile_defaults_to_the_card():
    import repro_torch.api as codr
    spec = codr.ModelSpec([codr.LayerSpec.conv(
        np.ones((4, 2, 3, 3), np.float32), name="c0")])
    if torch.cuda.is_available():
        assert codr.compile(spec).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            codr.compile(spec)
    assert codr.compile(spec, device="cpu").device.type == "cpu"


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """Alone in a directory (no ``src/`` beside it) it cannot run; in the
    checkout, without a card, it exits non-zero too.  Neither prints a
    result."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    runs = [(tmp_path, alone)]
    if not torch.cuda.is_available():      # with a card it would run for real
        runs.append((ROOT, ROOT / "chip_smoke.py"))
    for cwd, script in runs:
        res = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=120)
        assert res.returncode != 0
        assert '"ok"' not in res.stdout
