"""The port imports no `jax`: every module of inverted_index_2_tpu_torch
imports in a fresh interpreter whose import system refuses `jax`."""
import pkgutil
import subprocess
import sys
from pathlib import Path

import inverted_index_2_tpu_torch

_PROBE = r"""
import importlib, sys

class BlockJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError("jax is blocked: " + name)
        return None

sys.meta_path.insert(0, BlockJax())
for mod in sys.argv[1:]:
    importlib.import_module(mod)
assert "jax" not in sys.modules
print("imported", len(sys.argv) - 1)
"""


def _modules():
    pkg = inverted_index_2_tpu_torch
    names = [pkg.__name__]
    for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        names.append(info.name)
    return names


def test_port_imports_without_jax():
    mods = _modules()
    assert {"inverted_index_2_tpu_torch.models.query_engine",
            "inverted_index_2_tpu_torch.ops.cuda_fused",
            "inverted_index_2_tpu_torch.ops.cuda_decode"} <= set(mods)
    root = Path(inverted_index_2_tpu_torch.__file__).resolve().parents[1]
    res = subprocess.run([sys.executable, "-c", _PROBE, *mods],
                         capture_output=True, text=True, cwd=root,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert f"imported {len(mods)}" in res.stdout


def test_no_jax_import_in_sources():
    pkg = Path(inverted_index_2_tpu_torch.__file__).resolve().parent
    for path in pkg.rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.split()
            assert not (words[:1] in (["import"], ["from"])
                        and words[1].split(".")[0] in ("jax", "jaxlib")), path
