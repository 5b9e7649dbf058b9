"""Host-side utilities (counterpart of `tempo_tpu/utils/__init__.py`)."""

import os as _os


def fsync_dir(path: str) -> None:
    """Persist a directory's entries themselves: after creating,
    renaming, or deleting a file, the DIRENT is only crash-durable once
    the directory fd is fsynced (the block WAL, `block/wal.py`, depends on
    this for its recovery contract)."""
    dfd = _os.open(path, _os.O_RDONLY)
    try:
        _os.fsync(dfd)
    finally:
        _os.close(dfd)
