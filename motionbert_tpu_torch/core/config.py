"""Config system: YAML -> attribute-access dict, with `!include` support.

The port's own copy of ``motionbert_tpu/core/config.py``: YAML files with an
``!include`` constructor resolving paths relative to the including file,
attribute access on the resulting dict, and a ``name`` key derived from the
config filename.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import IO, Any

import yaml


class ConfigDict(dict):
    """A dict with attribute access, recursively applied to nested dicts."""

    def __init__(self, d: dict | None = None, **kwargs):
        super().__init__()
        for k, v in {**(d or {}), **kwargs}.items():
            self[k] = self._wrap(v)

    @classmethod
    def _wrap(cls, v):
        if isinstance(v, dict) and not isinstance(v, ConfigDict):
            return cls(v)
        if isinstance(v, (list, tuple)):
            return type(v)(cls._wrap(x) for x in v)
        return v

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = self._wrap(value)

    def __delattr__(self, name):
        try:
            del self[name]
        except KeyError as e:
            raise AttributeError(name) from e


class _IncludeLoader(yaml.SafeLoader):
    """YAML loader that resolves `!include` relative to the current file."""

    def __init__(self, stream: IO) -> None:
        try:
            self._root = os.path.split(stream.name)[0]
        except AttributeError:
            self._root = os.path.curdir
        super().__init__(stream)


def _construct_include(loader: _IncludeLoader, node: yaml.Node) -> Any:
    filename = os.path.abspath(
        os.path.join(loader._root, loader.construct_scalar(node)))
    ext = os.path.splitext(filename)[1].lstrip(".")
    with open(filename, "r") as f:
        if ext in ("yaml", "yml"):
            return yaml.load(f, _IncludeLoader)
        if ext == "json":
            return json.load(f)
        return f.read()


_IncludeLoader.add_constructor("!include", _construct_include)


def get_config(config_path: str) -> ConfigDict:
    """Load a YAML config into a ConfigDict; sets cfg.name from the filename."""
    with open(config_path, "r") as stream:
        raw = yaml.load(stream, Loader=_IncludeLoader)
    cfg = ConfigDict(raw or {})
    cfg.name = os.path.splitext(os.path.basename(config_path))[0]
    return cfg


def read_pkl(path: str):
    """Unpickle a file of this repository's datasets (trusted input)."""
    with open(path, "rb") as f:
        return pickle.load(f)
