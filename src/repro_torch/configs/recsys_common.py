"""The recommender family's cells, JAX's ``recsys_common`` tables:

  train_batch    — train_step, batch 65,536
  serve_p99      — pointwise scoring, batch 512 (online)
  serve_bulk     — pointwise scoring, batch 262,144 (offline)
  retrieval_cand — ONE user vs 1,000,000 candidates (broadcast scoring)

JAX's ``make_recsys_arch`` and ``SPEC`` (the dry-run cells on a mesh) are not
here: they wait for the port's training plumbing of several devices."""

RS_SHAPES = {
    "train_batch": dict(batch=65536, entry="train"),
    "serve_p99": dict(batch=512, entry="serve"),
    "serve_bulk": dict(batch=262144, entry="serve"),
    "retrieval_cand": dict(batch=1, n_candidates=1_000_000, entry="retrieval"),
}

SMOKE_SHAPES = {
    "train_batch": dict(batch=32, entry="train"),
    "serve_p99": dict(batch=16, entry="serve"),
    "serve_bulk": dict(batch=64, entry="serve"),
    "retrieval_cand": dict(batch=1, n_candidates=256, entry="retrieval"),
}
