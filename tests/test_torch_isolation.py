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

    # the towers: weights drawn, converted or served only where asked
    from repro_torch import convert
    from repro_torch.configs.bimetric_paper import cheap_tower_smoke
    from repro_torch.models import transformer
    from repro_torch.serve.engine import EmbedTower

    cfg = cheap_tower_smoke()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        transformer.init_params(0, cfg)
    model = transformer.init_params(0, cfg, device="cpu")
    # the model's weights as a JAX pytree: dense_blocks stacked over layers
    pytree = {"dense_blocks": {}}
    for name, w in model.named_parameters():
        if name.startswith("blocks."):
            *outer, leaf = name.split(".", 2)[2].split(".")
            node = pytree["dense_blocks"]
            for key in outer:
                node = node.setdefault(key, {})
            node.setdefault(leaf, []).append(w.detach().numpy())
        else:
            pytree[name] = w.detach().numpy()
    pytree["dense_blocks"] = {
        k: ({kk: np.stack(vv) for kk, vv in v.items()} if isinstance(v, dict)
            else np.stack(v)) for k, v in pytree["dense_blocks"].items()}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.transformer_from_numpy(pytree, cfg)
    again = convert.transformer_from_numpy(pytree, cfg, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(again.parameters(),
                                                  model.parameters()))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EmbedTower(again)
    toks = np.zeros((3, 5), np.int64)
    assert EmbedTower(again, device="cpu").embed(toks).shape == (3, 32)


def test_gnn_entry_points_without_device_raise_on_cpu_host():
    """The GAT's weights, their conversion and the corpus-search twin run
    on the card unless told otherwise; with no card they raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: device=None means the card")
    from repro_torch import convert
    from repro_torch.configs import gat_cora
    from repro_torch.launch import gnn_corpus_search
    from repro_torch.models import gnn

    cfg = gat_cora.smoke("molecule")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gnn.init_params(0, cfg)
    model = gnn.init_params(0, cfg, device="cpu")
    pytree = convert.gat_to_numpy(model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.gat_from_numpy(pytree, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gnn_corpus_search.main(["--n-nodes", "64"])
    x = torch.zeros(4, cfg.d_in)
    edges = torch.tensor([0, 1, -1], dtype=torch.int32)
    assert gnn.forward(convert.gat_from_numpy(pytree, cfg, device="cpu"), x,
                       edges, edges).shape == (4, cfg.n_classes)


def test_registry_entry_points_without_device_raise_on_cpu_host():
    """Every arch's initialiser in the registry draws on the card unless
    told otherwise, and the launcher trains there: with no card they raise.
    The abstract arguments need no device (the meta device)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: device=None means the card")
    from repro_torch.configs import ARCHS, EXTRA_ARCHS
    from repro_torch.launch import train as launch_train

    for name, spec in {**ARCHS, **EXTRA_ARCHS}.items():
        cfg = spec.make_config(True)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            spec.init_params(0, cfg)
        args = spec.build_cell(cfg, next(iter(spec.shapes)),
                               smoke=True).abstract_args()
        assert next(iter(args[0].parameters())).device.type == "meta", name
        spec.init_params(0, cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--arch", "granite-20b", "--steps", "1"])


def test_mesh_entry_points_without_device_raise_on_cpu_host():
    """A mesh takes the cards unless told otherwise: with no card
    ``make_host_mesh()`` and ``make_mesh`` without devices raise, and with
    ``device="cpu"`` (the CPU counts as one device) they build; the
    training modules import without JAX (above)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: device=None means the card")
    from repro_torch.launch import mesh

    with pytest.raises(RuntimeError, match="device='cpu'"):
        mesh.make_host_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mesh.make_mesh((2, 2), ("data", "model"))
    assert mesh.make_host_mesh(device="cpu").size == 1
    assert mesh.make_mesh((1, 1), ("data", "model"), device="cpu").size == 1
    with pytest.raises(ValueError, match="needs 4 devices"):
        mesh.make_mesh((2, 2), ("data", "model"), device="cpu")
