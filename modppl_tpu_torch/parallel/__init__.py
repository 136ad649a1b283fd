"""Resampling and the sharded-tier particle filter (one device for now)."""
