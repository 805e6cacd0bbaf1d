"""The device's idle share of the profiled span: one less the union of
its kernels' and copies' intervals over the span's wall."""

from benchmark.trace import idle_share


def read(run):
    return idle_share(run)
