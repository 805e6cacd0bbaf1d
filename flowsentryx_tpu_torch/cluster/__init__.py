"""Coordinator-less multi-engine scale-out on one host.

Counterpart of ``flowsentryx_tpu/cluster/`` (fixed-size, single-host
fleet).  ``cli cluster --engines N`` runs N full engine processes, each
owning a shard span of the daemon's IP-hash fan-out end to end — drain
workers, dispatch arena, flow table, its own CUDA context — sharing
only the blacklist: pairwise SPSC verdict-gossip mailboxes
(:mod:`.mailbox`) merged between dispatches (:mod:`.gossip`), supervised
crash-fail-open with checkpoint restarts (:mod:`.supervisor`,
:mod:`.runner`).  Importing this package imports no torch.
"""

from flowsentryx_tpu_torch.cluster.gossip import GossipPlane, create_plane
from flowsentryx_tpu_torch.cluster.mailbox import (
    StatusBlock, VerdictMailbox, mailbox_path, status_path,
)
from flowsentryx_tpu_torch.cluster.supervisor import ClusterSupervisor

__all__ = [
    "ClusterSupervisor", "GossipPlane", "StatusBlock", "VerdictMailbox",
    "create_plane", "mailbox_path", "status_path",
]
