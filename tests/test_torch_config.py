"""The port's config is a copy of the JAX package's, and the port imports
neither jax nor anything of orion_tpu."""

import ast
import dataclasses
import os
import shutil
import subprocess
import sys

import pytest

from orion_tpu import config as j_config
from orion_tpu_torch import config
from tests import torch_threads  # noqa: F401  (one intra-op thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_same_presets():
    assert list(config.list_presets()) == list(j_config.list_presets())


@pytest.mark.parametrize("preset", list(j_config.list_presets()))
def test_preset_equal_field_by_field(preset):
    assert dataclasses.asdict(config.get_config(preset)) == dataclasses.asdict(
        j_config.get_config(preset))


@pytest.mark.parametrize("overrides", [
    ["model.n_layers=4", "inference.page_size=16"],
    ["model.sliding_window=none", "inference.temperature=0.7",
     "parallel.dp=2"],
    ["model.remat=none", "data.batch_size=3"],
])
def test_overrides_apply_identically(overrides):
    want = dataclasses.asdict(j_config.get_config("tiny-llama", overrides))
    assert dataclasses.asdict(config.get_config("tiny-llama", overrides)) == want


def test_unknown_override_key_rejected():
    with pytest.raises(ValueError, match="unknown config key"):
        config.get_config("tiny-llama", ["model.no_such_field=1"])


def test_port_imports_without_jax_or_orion_tpu():
    """With jax made unimportable, every module of the port imports (the
    training modules and ``python -m orion_tpu_torch.train``'s among
    them), every preset loads (numpy knows bfloat16 only through jax's
    ml_dtypes), and no orion_tpu module gets loaded on the way."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import orion_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    orion_tpu_torch.__path__, 'orion_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "from orion_tpu_torch.config import get_config, list_presets\n"
        "for p in list_presets():\n"
        "    get_config(p)\n"
        "need = {'orion_tpu_torch.train', 'orion_tpu_torch.train.__main__',\n"
        "        'orion_tpu_torch.train.trainer', 'orion_tpu_torch.train.optimizer',\n"
        "        'orion_tpu_torch.data.loader', 'orion_tpu_torch.metrics'}\n"
        "assert need <= set(names), sorted(need - set(names))\n"
        "bad = [m for m, mod in sys.modules.items() if mod is not None and (\n"
        "       m == 'orion_tpu' or m.startswith(('orion_tpu.', 'jax')))]\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH")) if p)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


def test_chip_smoke_imports_neither_jax_nor_orion_tpu():
    tree = ast.parse(open(os.path.join(REPO, "chip_smoke.py")).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module or "")
    top = {n.split(".")[0] for n in names}
    assert "jax" not in top and "orion_tpu" not in top, sorted(names)
    assert "orion_tpu_torch" in top


def test_chip_smoke_fails_without_a_gpu_or_outside_the_repo(tmp_path):
    """Here (no CUDA) and from a directory holding chip_smoke.py alone, the
    script exits non-zero and prints no result line."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    for cwd in (REPO, str(tmp_path)):
        out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
