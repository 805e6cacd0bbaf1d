"""Partition rules (counterpart of ``flowsentryx_tpu/parallel/``): the
cluster tier's numpy half, :mod:`.layout`.  The sharded step's mesh and
sharding specs are not ported (ROADMAP queue 1)."""
