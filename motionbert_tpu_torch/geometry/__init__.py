"""Skeleton conventions."""
