"""Configuration: the JAX package's enums and dataclasses, shared.

``graphtap_tpu/config.py`` is plain Python (no jax), so the port re-exports
its classes, loaded by path (see ``_host.py``), rather than copying them.
"""

from __future__ import annotations

from graphtap_tpu_torch import _host

_cfg = _host.load("config")

Compression = _cfg.Compression
Ordering = _cfg.Ordering
GraphConfig = _cfg.GraphConfig
EngineConfig = _cfg.EngineConfig

__all__ = ["Compression", "Ordering", "GraphConfig", "EngineConfig"]
