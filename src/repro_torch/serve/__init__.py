"""Bi-metric serving. So far the embedding tower (``engine.EmbedTower``);
the engine, its slot pool and its fault handling come in a later slice."""
