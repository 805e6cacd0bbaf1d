"""The host pipeline's thread protocol and its static checks: the
dispatch/sink hand-off (:mod:`.channel`), its timing table
(:mod:`.tuning`), the thread-contract lint over the port's source
(:mod:`.contracts`) and the bounded interleaving model checker over the
port's real protocol objects (:mod:`.interleave`).

Counterpart of ``flowsentryx_tpu/sync/``.  ``channel``, ``tuning`` and
``contracts`` use the standard library only; ``interleave`` drives the
port's objects (numpy, and torch through the arena).
"""
