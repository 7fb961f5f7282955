"""Carry parameter trees across packages: the reference's tree of numpy
arrays (``{"embed", "final_norm", "layers": {...}, ["lm_head"]}``, layers
stacked on a leading ``n_layers`` axis) to tensors and back.

``params_from_numpy(tree, device=...)`` makes each leaf a tensor on
``device`` (cast to ``dtype`` if one is named); ``params_to_numpy(tree)``
copies each tensor to the host as a numpy array, bfloat16 leaves as float32
(numpy has no bfloat16).  Containers are nested dicts; keys are kept.
"""
from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import torch


def params_from_numpy(
    tree: Any,
    *,
    device: Union[str, torch.device],
    dtype: Optional[torch.dtype] = None,
) -> Any:
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device=device, dtype=dtype) for k, v in tree.items()}
    t = torch.from_numpy(np.array(tree, copy=True))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_to_numpy(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    t = tree.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()
