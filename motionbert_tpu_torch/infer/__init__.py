"""Batched inference helpers."""
