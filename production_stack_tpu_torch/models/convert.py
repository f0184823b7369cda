"""Carry parameters across from the JAX package's layout.

The JAX package's params are a nested dict of arrays (layer weights
stacked on axis 0, projection weights ``(in, out)``); the port uses the
same layout, so conversion is leaf by leaf. Callers hand over numpy
arrays (``np.asarray`` of each JAX leaf), which keeps the port free of
any JAX import.
"""

from __future__ import annotations

import numpy as np
import torch


def _leaf(x, device, dtype):
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        # numpy's bfloat16 extension type has no torch counterpart in
        # from_numpy: widen exactly to float32, then narrow below
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        # a copy: the source may be a read-only view of another
        # framework's buffer
        t = torch.from_numpy(np.array(a))
    return t.to(device=device, dtype=dtype if dtype is not None else t.dtype)


def params_from_numpy(tree: dict, device: str | torch.device = "cuda",
                      dtype: torch.dtype | None = None) -> dict:
    """Nested dict of numpy arrays -> the same dict of tensors on
    `device`, cast to `dtype` (None keeps each leaf's own type)."""
    return {
        k: (params_from_numpy(v, device, dtype) if isinstance(v, dict)
            else _leaf(v, device, dtype))
        for k, v in tree.items()
    }
