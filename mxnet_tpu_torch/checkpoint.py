"""Checkpoint file primitives of the PyTorch port.

The part of ``mxnet_tpu/checkpoint.py`` (``:83-130``) that
``Trainer.save_states`` needs: :func:`atomic_write` and the trainer
states header's magic and version.  ``CheckpointManager`` and
``auto_resume`` are not ported yet (ROADMAP Queue 1 item 5).
"""

from __future__ import annotations

import contextlib
import itertools
import os

__all__ = ["atomic_write", "TRAINER_STATES_MAGIC", "TRAINER_STATES_VERSION"]

# Trainer.save_states header: magic, one version byte, a newline, then
# the pickled states; a legacy headerless pickle still loads
TRAINER_STATES_MAGIC = b"MXTPUTRAINER"
TRAINER_STATES_VERSION = 1

_tmp_seq = itertools.count(1)


@contextlib.contextmanager
def atomic_write(path):
    """Yield a temporary path in ``path``'s directory; on a clean exit
    fsync it, rename it onto ``path`` and fsync the directory, so the
    final name only ever holds a whole file.  On an error the temporary
    file is removed and ``path`` is left as it was."""
    path = os.path.abspath(path)
    d = os.path.dirname(path)
    tmp = os.path.join(d, ".%s.%d.%d.tmp" % (os.path.basename(path),
                                             os.getpid(), next(_tmp_seq)))
    try:
        yield tmp
        _fsync(tmp)
        os.replace(tmp, path)
        with contextlib.suppress(OSError):
            # makes the rename durable; some filesystems refuse it
            _fsync(d)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise


def _fsync(path):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
