"""The training UI's storage layer (A9.5 ports the rest of ``ui/``).

Counterpart of ``deeplearning4j_tpu/ui/storage.py`` only, taken ahead of the
UI because the trace store indexes kept traces through
:class:`~.storage.FileStatsStorage`.
"""
from .storage import (FileStatsStorage, InMemoryStatsStorage, Persistable,
                      StatsStorage, StatsStorageEvent, StatsStorageRouter)

__all__ = ["Persistable", "StatsStorageEvent", "StatsStorageRouter",
           "StatsStorage", "InMemoryStatsStorage", "FileStatsStorage"]
