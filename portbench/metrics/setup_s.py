"""Process start to the window's opening: import, kernel libraries,
the input rings, the encoder, the IDR slot and the warm-up P slot."""


def read(r):
    return r.setup_s
