"""Device copies of the constant lookup tables (spec tables, cost
tables, mode orders), made once per (table, device, dtype)."""

from __future__ import annotations

import torch

_cache: dict = {}


def device_table(values, device, dtype=torch.int32):
    """The module-level constant array `values` as a tensor on `device`.
    The cache keeps `values` alive with its copy, so its id() stays a
    valid key."""
    key = (id(values), torch.device(device), dtype)
    hit = _cache.get(key)
    if hit is None:
        hit = _cache[key] = (values, torch.as_tensor(values, dtype=dtype,
                                                     device=device))
    return hit[1]
