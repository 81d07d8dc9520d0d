"""The set-up's IDR slot of all S streams, synchronised, its NALs
pulled; layer: I encode."""


def read(r):
    return r.idr_slot_s
