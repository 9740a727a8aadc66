"""Local and gs:// file I/O for the reports.

This package's copy of nerf_from_image_tpu/utils/fileio.py. Report paths
may name `gs://` buckets, opened through tf.io.gfile as the JAX package
does; TensorFlow is imported only for such a path, so local paths need
nothing beyond the standard library.
"""

from __future__ import annotations

import contextlib
import io
import os
import pathlib


def is_gcs(path: str) -> bool:
    return str(path).startswith("gs://")


@contextlib.contextmanager
def open_file(path: str, mode: str = "r"):
    """Opens a local or gs:// file; a gs:// file read in binary is
    buffered whole."""
    if is_gcs(path):
        from tensorflow.io import gfile

        with gfile.GFile(path, mode) as f:
            yield io.BytesIO(f.read()) if "r" in mode and "b" in mode else f
    else:
        with open(path, mode) as f:
            yield f


def mkdir(path: str) -> None:
    """mkdir -p for a local or gs:// path."""
    if is_gcs(path):
        from tensorflow.io import gfile

        gfile.makedirs(path)
    else:
        pathlib.Path(path).mkdir(parents=True, exist_ok=True)


def file_exists(path: str) -> bool:
    if is_gcs(path):
        from tensorflow.io import gfile

        return gfile.exists(path)
    return os.path.isfile(path)


def replace_file(tmp: str, dst: str) -> None:
    """Moves tmp over dst: a rename locally; on GCS, which has no rename,
    a copy then a delete, so the old dst survives until the new one is
    whole."""
    if is_gcs(dst) or is_gcs(tmp):
        from tensorflow.io import gfile

        gfile.copy(tmp, dst, overwrite=True)
        gfile.remove(tmp)
    else:
        os.replace(tmp, dst)
