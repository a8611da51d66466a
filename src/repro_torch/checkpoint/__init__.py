from repro_torch.checkpoint.manager import CheckpointManager, config_hash  # noqa: F401
