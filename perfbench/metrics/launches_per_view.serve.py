"""Device operations (kernels, copies and sets) per served view, from the
device window."""


def read(t):
    return t.launches / t.steps if t.launches else None
