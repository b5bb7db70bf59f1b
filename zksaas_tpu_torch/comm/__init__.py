"""The star-protocol transports: LocalNet (all parties in one process),
HostStarNet (one process a party over the TCP star, comm/star.py) and the
round journal JournalNet over either."""

from .journal import JournalNet
from .net import LocalNet

__all__ = ["LocalNet", "JournalNet"]
