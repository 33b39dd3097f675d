"""Prefill / serve step functions.

Port of ``src/repro/training/step.py`` (``make_prefill_step``,
``make_serve_step``). There is no ``jit``: the steps run eagerly. The
optimizer and the train step come with the training slice.
"""
from __future__ import annotations

from typing import Callable


def make_prefill_step(model) -> Callable:
    def prefill_step(params, batch):
        return model.prefill(params, batch["tokens"])

    return prefill_step


def make_serve_step(model, greedy: bool = True) -> Callable:
    """One decode step: (params, state, tokens[B,1]) -> (next[B,1], state).
    The state's cache is updated in place (see ``LM.decode_step``)."""

    def serve_step(params, state, tokens):
        logits, state = model.decode_step(params, state, tokens)
        nxt = logits[:, -1:, :].argmax(dim=-1)
        return nxt, state

    return serve_step
