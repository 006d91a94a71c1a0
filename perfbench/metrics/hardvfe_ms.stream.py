from perfbench.metrics import _read


def read(ctx):
    return _read.stage_ms(ctx, 'stream', ('HardVFE',))
