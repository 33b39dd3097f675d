"""Carry weights across from the reference package.

No reference module: the port cannot import ``repro``, so conversion works
by duck typing and through numpy.

- :func:`zoo_from_numpy`: any object with numpy-convertible ``W`` and
  ``centers`` (or ``None``), a ``sigma``, ``mode``, ``name`` and
  ``source_family`` (the reference's ``repro.core.zoo.ZooModel`` among
  them) becomes the port's :class:`repro_torch.core.zoo.ZooModel` with the
  same weights.
- :func:`lm_params_from_numpy`: the reference model's params (a nested
  dict of arrays, stacked ``[L, ...]``) become the port's dict of tensors
  with the same keys, dtypes and values: the LM's tree (``layers``, or a
  hybrid's ``cycles`` / ``rest{i}``) and the encoder-decoder's
  (``enc_proj``, ``enc_layers``, ``enc_norm``, ``dec_layers``) alike, as
  it walks any nested dict.
- :func:`adamw_state_from_numpy`: the reference's ``AdamWState`` (step,
  m, v) becomes the port's, so both packages can take a step from the
  same state.
"""
from __future__ import annotations

from typing import Iterable, List

import numpy as np
import torch

from repro_torch.core.zoo import ZooModel
from repro_torch.training.optimizer import AdamWState


def zoo_from_numpy(models: Iterable) -> List[ZooModel]:
    out = []
    for m in models:
        centers = getattr(m, "centers", None)
        out.append(ZooModel(
            name=str(m.name), source_family=str(m.source_family),
            W=np.array(m.W, dtype=np.float32),
            mode=str(m.mode),
            centers=(None if centers is None
                     else np.array(centers, dtype=np.float32)),
            sigma=float(m.sigma),
            meta=dict(getattr(m, "meta", None) or {})))
    return out


def _tensor_from_numpy(arr, device) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own (it is ml_dtypes' type, which
        # torch.from_numpy refuses): carry the bit pattern across
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def lm_params_from_numpy(tree, device="cpu"):
    """Nested dict of numpy-convertible arrays (float32 or bfloat16) ->
    the same nested dict of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: lm_params_from_numpy(v, device) for k, v in tree.items()}
    return _tensor_from_numpy(tree, device)


def adamw_state_from_numpy(state, device="cpu") -> AdamWState:
    """Any ``(step, m, v)`` with a numpy-convertible scalar step and nested
    dicts of moments -> the port's :class:`AdamWState` on ``device`` (step
    an int32 scalar)."""
    step, m, v = state
    return AdamWState(
        torch.tensor(int(np.asarray(step)), dtype=torch.int32, device=device),
        lm_params_from_numpy(m, device), lm_params_from_numpy(v, device))
