"""Records the sink received verdicts for, over the wall of the window
that served them, its drain included; in a traced run the first part of
the window, before the profiler starts.  On a host whose cores set the
pace (the ingest workers' sealing) this follows the host's speed of the
moment."""


def read(run):
    n, wall = run.served
    if not n or wall <= 0:
        return None
    return n / wall
