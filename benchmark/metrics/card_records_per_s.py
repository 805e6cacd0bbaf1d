"""Records verdicted in the window over the card's busy seconds in it:
the union of every kernel's and copy's interval over the whole window of
an untraced run (the device trace, CUDA activity alone).  The line rate
one card serves this deployment at once the host keeps it fed; the
host's pace between launches, which sets the served rate, does not
enter."""


def read(run):
    if not run.device_ops or run.device_busy_s <= 0 \
            or not run.mode.verdicted:
        return None
    return run.mode.verdicted / run.device_busy_s
