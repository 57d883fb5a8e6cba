"""Process start to the window's first iteration or request."""


def read(ctx):
    return ctx["setup_s"]
