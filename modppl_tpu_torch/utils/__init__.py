"""Inference diagnostics."""
