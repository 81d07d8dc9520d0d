"""A kernel family's share of its roofline in a traced run: the least
time the family's work needs (kernels/*.py with that ``ROOFLINE``,
counted from the cell's shapes, over peaks.py) over the device time the
trace gives the family's kernels (``DEVICE_KERNELS``), per P slot."""

from __future__ import annotations

from portbench import catalog, peaks


def share(r, family: str):
    """(percent, binding term) or None where nothing is read: no trace,
    no peak for the card, no work for the cell, or no launch traced."""
    if r.trace is None:
        return None
    peak = peaks.of(r.device_name)
    mods = [k for k in catalog.kernels() if k.ROOFLINE == family]
    works = [w for w in (k.work(r) for k in mods) if w is not None]
    names = {n for k in mods for n in k.DEVICE_KERNELS}
    dev_s = sum(s for name, s in r.trace["kernels"].items()
                if any(n in name for n in names)) / r.trace["slots"]
    if peak is None or not works or dev_s <= 0:
        return None
    least, term = peaks.least_seconds(peak, sum(w[0] for w in works),
                                      sum(w[1] for w in works))
    return 100.0 * least / dev_s, term
