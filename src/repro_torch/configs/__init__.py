"""The paper's experimental configuration."""
