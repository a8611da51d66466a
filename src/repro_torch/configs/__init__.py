"""Architecture registry: ``--arch <id>`` resolution for launchers and
tests, the counterpart of ``repro.configs``."""
from __future__ import annotations

from repro_torch.configs import (
    bert4rec,
    bimetric_paper,
    bst,
    deepseek_coder_33b,
    deepseek_v3_671b,
    din,
    gat_cora,
    granite_20b,
    granite_moe_3b_a800m,
    qwen3_0_6b,
    xdeepfm,
)

# the ten assigned architectures (+ the paper's own expensive tower)
ARCHS = {
    "qwen3-0.6b": qwen3_0_6b.SPEC,
    "granite-20b": granite_20b.SPEC,
    "deepseek-coder-33b": deepseek_coder_33b.SPEC,
    "granite-moe-3b-a800m": granite_moe_3b_a800m.SPEC,
    "deepseek-v3-671b": deepseek_v3_671b.SPEC,
    "gat-cora": gat_cora.SPEC,
    "bst": bst.SPEC,
    "din": din.SPEC,
    "bert4rec": bert4rec.SPEC,
    "xdeepfm": xdeepfm.SPEC,
}

EXTRA_ARCHS = {
    "sfr-mistral-7b": bimetric_paper.SPEC,
}


def get_arch(name: str):
    if name in ARCHS:
        return ARCHS[name]
    if name in EXTRA_ARCHS:
        return EXTRA_ARCHS[name]
    raise KeyError(f"unknown arch {name!r}; choose from "
                   f"{sorted(ARCHS) + sorted(EXTRA_ARCHS)}")


def all_cells() -> list[tuple[str, str]]:
    """The 40 assigned (arch × shape) cells."""
    return [(a, s) for a, spec in ARCHS.items() for s in spec.shapes]
