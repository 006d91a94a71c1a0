"""Set-up: process start to the window's start, in seconds."""


def read(ctx):
    return ctx["setup_s"]
