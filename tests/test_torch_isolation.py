"""The port stands alone: no module of ``repro_torch`` imports JAX or the
JAX package, and no entry point falls back to the CPU on its own."""
import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT / "src").with_suffix("")
        name = ".".join(rel.parts)
        yield path, name[: -len(".__init__")] if name.endswith(".__init__") else name


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", [p for p, _ in _modules()],
                         ids=[n for _, n in _modules()])
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


def test_imports_with_jax_blocked():
    """Every module imports in a process where JAX and the JAX package
    cannot be imported at all."""
    mods = [n for _, n in _modules()]
    code = textwrap.dedent(f"""
        import importlib, sys
        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in {FORBIDDEN!r}:
                    raise ImportError("blocked: " + name)
        sys.meta_path.insert(0, Block())
        for m in {mods!r}:
            importlib.import_module(m)
        assert not any(k.split(".")[0] in {FORBIDDEN!r} for k in sys.modules)
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert res.returncode == 0 and "ok" in res.stdout, res.stderr[-3000:]


def test_entry_points_without_device_raise_on_cpu_host():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: device=None means the card")
    from repro_torch.core import beam, bimetric, distances, vamana
    from repro_torch.data.synthetic import make_dataset

    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(64, 4)).astype(np.float32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_dataset(n=64, n_queries=2, dim_D=8, dim_d=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        vamana.build(x, vamana.VamanaConfig(max_degree=4, l_build=8,
                                            pool_size=8, rev_candidates=4))
    idx = vamana.build(x, vamana.VamanaConfig(
        max_degree=4, l_build=8, pool_size=8, rev_candidates=4,
        build_batch=32), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        vamana.search(idx, x, x[:2], k=3)
    fn = distances.EmbeddingMetric(x).dists_batch
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bimetric.bimetric_search(fn, fn, idx, x[:2], x[:2], n_points=64,
                                 quota=10)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bimetric.rerank_search(fn, fn, idx, x[:2], x[:2], n_points=64,
                               quota=10)
    entries = torch.zeros((2, 1), dtype=torch.int32)
    for shards in (1, 2):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            beam.sharded_greedy_search(x, idx.adjacency, x[:2], entries,
                                       shards=shards, beam_width=4)
    ids, _, _ = vamana.search(idx, x, x[:2], k=3, device="cpu")
    assert ids.device.type == "cpu"
