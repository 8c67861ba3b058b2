"""Deterministic, shardable, resumable synthetic data pipeline."""
