"""Datasets, readers and the batch loader of the port."""
