"""Vision models."""
