"""Serving engine pieces of ``repro.serve.engine``. So far only
:class:`EmbedTower`, the towers' entry point: token rows in, unit
embeddings out."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.backend import resolve_device
from repro_torch.models import transformer as T


@dataclasses.dataclass
class EmbedTower:
    """An embedding tower: ``model`` (its config is ``model.cfg``), run on
    the model's device under ``torch.inference_mode()``. ``device`` follows
    the port's rule, the card unless ``"cpu"``, and must be the kind of
    device the model is on."""

    model: T.Transformer
    device: str | torch.device | None = None

    def __post_init__(self):
        kind = resolve_device(self.device).type
        self.device = self.model.embed.device
        if self.device.type != kind:
            raise ValueError(f"EmbedTower: the model is on {self.device}, "
                             f"not on {kind}")

    @property
    def cfg(self) -> T.TransformerConfig:
        return self.model.cfg

    def embed(self, tokens: np.ndarray, batch: int = 64) -> np.ndarray:
        """(N, S) token ids -> (N, embed_dim) f32 unit rows, ``batch`` rows
        a forward pass; the last batch is padded with zero rows, which are
        sliced off."""
        n = tokens.shape[0]
        pad = (-n) % batch
        toks = np.pad(tokens, ((0, pad), (0, 0))) if pad else tokens
        out = []
        with torch.inference_mode():
            for s in range(0, len(toks), batch):
                t = torch.from_numpy(np.ascontiguousarray(toks[s:s + batch]))
                out.append(T.embed_pool(self.model, t.to(self.device)).cpu()
                           .numpy())
        return np.concatenate(out)[:n]
