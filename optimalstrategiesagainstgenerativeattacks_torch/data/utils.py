"""Filesystem helpers of the dataset readers.

A copy of ``optimalstrategiesagainstgenerativeattacks_tpu/data/utils.py``
(parity with the reference's ``data_handling/utils.py:8-59``), kept in the
port so that it needs nothing of the JAX package.
"""

from __future__ import annotations

import os


def list_dir(root: str, prefix: bool = False):
    """All directories directly under root (optionally path-prefixed)."""
    root = os.path.expanduser(root)
    directories = [p for p in sorted(os.listdir(root)) if os.path.isdir(os.path.join(root, p))]
    if prefix:
        directories = [os.path.join(root, d) for d in directories]
    return directories


def list_files(root: str, suffix, prefix: bool = False):
    """All files under root ending with suffix (str or tuple)."""
    root = os.path.expanduser(root)
    files = [
        p
        for p in sorted(os.listdir(root))
        if os.path.isfile(os.path.join(root, p)) and p.endswith(suffix)
    ]
    if prefix:
        files = [os.path.join(root, f) for f in files]
    return files


def list_files_rec(root: str, suffix):
    """Recursive file listing by suffix."""
    root = os.path.expanduser(root)
    files = []
    for curr_root, _, curr_files in os.walk(root):
        for file_name in sorted(curr_files):
            file_path = os.path.join(curr_root, file_name)
            if file_name.endswith(suffix) and os.path.isfile(file_path):
                files.append(file_path)
    return files
