"""Carry weights across from the reference package.

No reference module: the port cannot import ``repro``, so conversion works
by duck typing. Any object with numpy-convertible ``W`` and ``centers``
(or ``None``), a ``sigma``, ``mode``, ``name`` and ``source_family`` —
the reference's ``repro.core.zoo.ZooModel`` among them — becomes the
port's :class:`repro_torch.core.zoo.ZooModel` with the same weights.
"""
from __future__ import annotations

from typing import Iterable, List

import numpy as np

from repro_torch.core.zoo import ZooModel


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
