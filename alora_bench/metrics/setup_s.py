"""Process start to the window's opening (host clock, s): the kernels
loaded or built, the weights drawn, the engine built and the ramp of
the cell's own traffic."""


def read(rec):
    return rec.setup_s
