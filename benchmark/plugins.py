"""Finds by name what belongs to one configuration or traffic mix: a
module benchmark/<kind>/<name>.py, where kind is `entries` (the driver a
traffic mix names), `compare` (that entry's comparison), `targets` (the
configuration's target.kind), `readmodels` (its reads.model), `scoring`
(its scoring.matrix) or `metrics` (a per-layer or end-to-end reader).  A later configuration or mix of another kind adds
a module here and edits none."""

from __future__ import annotations

import importlib.util
import os

HERE = os.path.dirname(os.path.abspath(__file__))
_LOADED: dict = {}


def plugin(kind: str, name: str):
    path = os.path.join(HERE, kind, name + ".py")
    if path not in _LOADED:
        if not os.path.isfile(path):
            raise ValueError(f"no {kind} module {name!r} ({path})")
        spec = importlib.util.spec_from_file_location(
            f"benchmark_{kind}_{name}".replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[path] = mod
    return _LOADED[path]


def make_target(cfg: dict, tmp: str) -> dict:
    """name, seq (bytes) and FASTA path of the configuration's target,
    with whatever its read model derives from it."""
    t = plugin("targets", cfg["target"]["kind"]).make(cfg["target"], tmp)
    plugin("readmodels", cfg["reads"]["model"]).prepare(cfg["reads"], t)
    return t


def sample_reads(cfg: dict, target: dict, n: int, rng, first: int = 0):
    """n (name, seq, qual) records of the configuration's read model."""
    return plugin("readmodels", cfg["reads"]["model"]).sample(
        cfg["reads"], target, n, rng, first)


def scoring(cfg: dict):
    """The configuration's scoring module (TABLE, matrix(scoring))."""
    return plugin("scoring", cfg["scoring"]["matrix"])
