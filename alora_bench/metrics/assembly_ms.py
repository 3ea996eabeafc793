"""Host time a step spends packing its batch and uploading it: growth
of ``Engine.t_assembly + ModelRunner.t_assembly`` over the window,
per mixed step in the window (ms)."""


def read(rec):
    if not rec.mixed_steps:
        return None
    return rec.assembly_s / rec.mixed_steps * 1e3
