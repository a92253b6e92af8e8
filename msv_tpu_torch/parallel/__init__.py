"""Long-file streaming (``streaming``).  The multi-GPU modules
(``sharded``, ``mesh``, ``multihost``) wait for ROADMAP queue 1 item 10."""

from .streaming import streaming_spec_db, streaming_spec_db_mmap

__all__ = ["streaming_spec_db", "streaming_spec_db_mmap"]
