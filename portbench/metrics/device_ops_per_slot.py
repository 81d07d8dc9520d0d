"""Device activities (kernels, copies, memsets) per traced P slot: the
dispatches the host pays for."""


def read(r):
    if r.trace is None or not r.trace["device_ops"]:
        return None
    return r.trace["device_ops"] / r.trace["slots"]
