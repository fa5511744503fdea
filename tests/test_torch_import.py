"""The port imports neither `jax` nor the JAX package: every module of
inverted_index_2_tpu_torch, bench_torch.py and the two examples
(examples/*_torch.py) import in a fresh interpreter whose import system
refuses `jax`, `jaxlib`, `inverted_index_2_tpu`, `bench` and
`__graft_entry__`, and no source of the port, of chip_smoke.py, of
bench_torch.py or of those examples names one of them in an import."""
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import inverted_index_2_tpu_torch

_PROBE = r"""
import importlib, importlib.util, sys

BLOCKED = ("jax", "jaxlib", "inverted_index_2_tpu", "bench",
           "__graft_entry__")

class BlockJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, BlockJax())
for mod in sys.argv[1:]:
    if mod.endswith(".py"):  # a script: load it as a module, not __main__
        spec = importlib.util.spec_from_file_location("probe_script", mod)
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
    else:
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


def _root() -> Path:
    return Path(inverted_index_2_tpu_torch.__file__).resolve().parents[1]


def _scripts():
    """The files beside the package that the port adds."""
    root = _root()
    return [root / "bench_torch.py"] + sorted(
        (root / "examples").glob("*_torch.py"))


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
            "inverted_index_2_tpu_torch.models.checkpoint",
            "inverted_index_2_tpu_torch.entry"} <= set(mods)
    scripts = [str(p) for p in _scripts()]
    assert {Path(p).name for p in scripts} == {
        "bench_torch.py", "quickstart_torch.py", "serving_mesh_torch.py"}
    res = subprocess.run([sys.executable, "-c", _PROBE, *mods, *scripts],
                         capture_output=True, text=True, cwd=_root(),
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert f"imported {len(mods) + len(scripts)}" in res.stdout


# an import statement naming jax, jaxlib, the JAX package, the JAX bench
# or the JAX entry module (the names exactly: inverted_index_2_tpu_torch is
# the port, bench_torch its bench)
_FORBIDDEN = re.compile(
    r"^\s*(?:from|import)\s+"
    r"(?:jax|jaxlib|inverted_index_2_tpu|bench|__graft_entry__)\b")


def _sources():
    root = Path(inverted_index_2_tpu_torch.__file__).resolve().parent
    return (sorted(root.rglob("*.py")) + [root.parent / "chip_smoke.py"]
            + _scripts())


def test_no_jax_import_in_sources():
    paths = _sources()
    assert {"chip_smoke.py", "bench_torch.py", "quickstart_torch.py",
            "serving_mesh_torch.py"} <= {p.name for p in paths}
    names = {p.parent.name + "/" + p.name for p in paths}
    assert {"models/host_serve.py", "models/checkpoint.py",
            "codec/bitmask.py", "inverted_index_2_tpu_torch/entry.py"} <= names
    for path in paths:
        for n, line in enumerate(path.read_text().splitlines(), 1):
            assert not _FORBIDDEN.match(line), f"{path}:{n}: {line}"


def test_the_source_scan_finds_such_imports():
    for line in ("import jax", "from jax import numpy", "import jaxlib",
                 "    from inverted_index_2_tpu.codec import keys",
                 "import inverted_index_2_tpu as tpi",
                 "from inverted_index_2_tpu import InvertedIndex",
                 "import bench", "from bench import gen_corpus",
                 "import __graft_entry__",
                 "from __graft_entry__ import entry"):
        assert _FORBIDDEN.match(line), line
    for line in ("from inverted_index_2_tpu_torch import QueryEngine",
                 "import inverted_index_2_tpu_torch",
                 "import bench_torch", "from bench_torch import main",
                 "# the JAX package (inverted_index_2_tpu) is the reference"):
        assert not _FORBIDDEN.match(line), line
