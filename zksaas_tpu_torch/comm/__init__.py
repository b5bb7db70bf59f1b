"""The star-protocol transports: LocalNet (all parties in one process),
HostStarNet (one process a party over the TCP star, comm/star.py), SpmdNet
(one process a party over torch.distributed) and the round journal
JournalNet over LocalNet or HostStarNet."""

from .journal import JournalNet
from .net import LocalNet, SpmdNet

__all__ = ["LocalNet", "JournalNet", "SpmdNet"]
