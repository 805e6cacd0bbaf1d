"""The host pipeline's thread protocol: the dispatch/sink hand-off
(:mod:`.channel`) and its timing table (:mod:`.tuning`).

Counterpart of ``flowsentryx_tpu/sync/`` (the channel and the constants
this port reads; the reference's contract checker and interleaving
model checker are not ported).  Standard library only.
"""
