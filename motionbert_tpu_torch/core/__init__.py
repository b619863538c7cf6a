"""Configuration and checkpoint reading."""
