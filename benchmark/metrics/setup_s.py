"""Process start until the window opens: the imports, the kernels'
build or cache load, the engine and its graph captures, the record pool,
the producer and the ingest workers."""


def read(run):
    return run.setup_s
