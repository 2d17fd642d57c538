"""Load the JAX package's numpy-only host files by path, without jax.

The host planner (``kernels/panel_plan.py`` and friends) is large and the
CUDA kernels are checked against their Pallas twins on the *same* plan
bytes, so the port reuses those files instead of re-writing them. They
import nothing but numpy, yet importing them the normal way runs
``graphtap_tpu/__init__.py``, which imports jax. This module executes
each file directly from its path as a private module of this package.

A few of those files do function-local imports of their siblings
(``from graphtap_tpu.kernels.gather_plan import ...`` in
``panel_plan.py``, ``from graphtap_tpu import native`` in
``ingest/io.py``). Each path-loaded module gets its own ``__import__``
that resolves exactly those names to the path-loaded siblings; any other
``graphtap_tpu`` import raises. Nothing named ``graphtap_tpu`` is put in
``sys.modules``, so a process that also imports the JAX package (the
parity tests) sees it unchanged.
"""

from __future__ import annotations

import builtins
import importlib.util
import sys
import types
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent.parent
JAX_PKG = REPO_ROOT / "graphtap_tpu"

# short name -> file of the JAX package (numpy-only files)
_FILES = {
    "config": "config.py",
    "native": "native/__init__.py",
    "rmat": "ingest/rmat.py",
    "io": "ingest/io.py",
    "gather_plan": "kernels/gather_plan.py",
    "panel_plan": "kernels/panel_plan.py",
}
# dotted names those files import -> short name
_ALIASES = {
    "graphtap_tpu.config": "config",
    "graphtap_tpu.native": "native",
    "graphtap_tpu.ingest.rmat": "rmat",
    "graphtap_tpu.ingest.io": "io",
    "graphtap_tpu.kernels.gather_plan": "gather_plan",
    "graphtap_tpu.kernels.panel_plan": "panel_plan",
}


def _import(name, globals=None, locals=None, fromlist=(), level=0):
    if level or not (name == "graphtap_tpu"
                     or name.startswith("graphtap_tpu.")):
        return builtins.__import__(name, globals, locals, fromlist, level)
    if not fromlist:
        raise ImportError(f"path-loaded host code may not 'import {name}'")
    if name in _ALIASES:                    # from graphtap_tpu.x.y import f
        return load(_ALIASES[name])
    # from graphtap_tpu[.x] import y
    ns = types.SimpleNamespace()
    for sub in fromlist:
        full = f"{name}.{sub}"
        if full not in _ALIASES:
            raise ImportError(f"{full} is not a numpy-only host module")
        setattr(ns, sub, load(_ALIASES[full]))
    return ns


def load_file(path: Path, modname: str) -> types.ModuleType:
    """Execute one Python file as module ``modname`` (registered in
    ``sys.modules`` under that private name, which dataclasses need)."""
    if modname in sys.modules:
        return sys.modules[modname]
    spec = importlib.util.spec_from_file_location(modname, str(path))
    mod = importlib.util.module_from_spec(spec)
    mod.__builtins__ = dict(vars(builtins), __import__=_import)
    sys.modules[modname] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[modname]
        raise
    return mod


def load(short: str) -> types.ModuleType:
    """The path-loaded module for one of the reused host files."""
    return load_file(JAX_PKG / _FILES[short], f"{__name__}.{short}")
