"""Entry point of the batch configurations: the port's BatchEncoder,
S lockstep streams of one slice per frame, one slot per call."""

from __future__ import annotations


class Entry:
    """What the harness drives: headers(), encode(frames or None ->
    per-stream NAL lists of the slot before, or None), recon() (the
    (y, u, v) reference planes of the newest slot, stream axis first),
    stage_clock(on), stage_times() (a {stage: seconds} per P slot since
    the clock went on), close()."""

    def __init__(self, param, S: int, device: str):
        from x264dsp_tpu_torch import params
        from x264dsp_tpu_torch.encoder import batch
        self._p_type = params.SLICE_TYPE_P
        self.be = batch.BatchEncoder(param, S, device=device)
        self._n0 = 0

    def headers(self):
        return self.be.headers()

    def encode(self, frames):
        return self.be.encode_batch(frames)

    def recon(self):
        return self.be.last_recon

    def stage_clock(self, on: bool) -> None:
        if on:
            self._n0 = len(self.be.slot_times)
        self.be.clock.enabled = on

    def stage_times(self) -> list[dict]:
        return [t for typ, t in self.be.slot_times[self._n0:]
                if typ == self._p_type]

    def close(self) -> None:
        self.be.close()


def open_entry(param, S: int, device: str) -> Entry:
    return Entry(param, S, device)
