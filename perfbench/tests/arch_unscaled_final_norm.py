"""A test-only architecture file: ``perfbench/archs/transformer.py`` with
one fault in its reference's ``loss``: the final norm's ``(1 + w)`` scale
taken as 1. A configuration that names this file has its train check
follow the faulty reference, so a sound program fails it."""
from perfbench.archs import transformer
from perfbench.archs.transformer import *  # noqa: F401,F403


def loss(cfg, w32, tokens, mm):
    # w x 0 keeps the leaf in the graph, with a gradient of 0
    return transformer.loss(
        cfg, dict(w32, final_norm=w32["final_norm"] * 0), tokens, mm)
