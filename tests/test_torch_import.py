"""The port imports neither `jax` nor the JAX package: every module of
inverted_index_2_tpu_torch imports in a fresh interpreter whose import
system refuses `jax`, `jaxlib` and `inverted_index_2_tpu`, and no source of
the port or of chip_smoke.py names either in an import."""
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import inverted_index_2_tpu_torch

_PROBE = r"""
import importlib, sys

BLOCKED = ("jax", "jaxlib", "inverted_index_2_tpu")

class BlockJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, BlockJax())
for mod in sys.argv[1:]:
    importlib.import_module(mod)
assert not any(m.split(".")[0] in BLOCKED for m in sys.modules)
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
            "inverted_index_2_tpu_torch.ops.cuda_decode",
            "inverted_index_2_tpu_torch.ops.cuda_sort",
            "inverted_index_2_tpu_torch.ops.cuda_bool",
            "inverted_index_2_tpu_torch.inverted_index",
            "inverted_index_2_tpu_torch.shard",
            "inverted_index_2_tpu_torch.segment.writer",
            "inverted_index_2_tpu_torch.codec.native",
            "inverted_index_2_tpu_torch.codec.bitmask",
            "inverted_index_2_tpu_torch.models.host_serve",
            "inverted_index_2_tpu_torch.models.checkpoint"} <= set(mods)
    root = Path(inverted_index_2_tpu_torch.__file__).resolve().parents[1]
    res = subprocess.run([sys.executable, "-c", _PROBE, *mods],
                         capture_output=True, text=True, cwd=root,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert f"imported {len(mods)}" in res.stdout


# an import statement naming jax, jaxlib or the JAX package (the name
# exactly: inverted_index_2_tpu_torch is the port)
_FORBIDDEN = re.compile(
    r"^\s*(?:from|import)\s+(?:jax|jaxlib|inverted_index_2_tpu)\b")


def _sources():
    root = Path(inverted_index_2_tpu_torch.__file__).resolve().parent
    return sorted(root.rglob("*.py")) + [root.parent / "chip_smoke.py"]


def test_no_jax_import_in_sources():
    paths = _sources()
    assert any(p.name == "chip_smoke.py" for p in paths)
    names = {p.parent.name + "/" + p.name for p in paths}
    assert {"models/host_serve.py", "models/checkpoint.py",
            "codec/bitmask.py"} <= names
    for path in paths:
        for n, line in enumerate(path.read_text().splitlines(), 1):
            assert not _FORBIDDEN.match(line), f"{path}:{n}: {line}"


def test_the_source_scan_finds_such_imports():
    for line in ("import jax", "from jax import numpy", "import jaxlib",
                 "    from inverted_index_2_tpu.codec import keys",
                 "import inverted_index_2_tpu as tpi",
                 "from inverted_index_2_tpu import InvertedIndex"):
        assert _FORBIDDEN.match(line), line
    for line in ("from inverted_index_2_tpu_torch import QueryEngine",
                 "import inverted_index_2_tpu_torch",
                 "# the JAX package (inverted_index_2_tpu) is the reference"):
        assert not _FORBIDDEN.match(line), line
