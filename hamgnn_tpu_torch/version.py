"""Version and start-up banner of the port, counterpart of
``hamgnn_tpu/version.py``."""

from __future__ import annotations

import os
import subprocess

__version__ = "0.1.0"

_BANNER = r"""
  _  _             ___ _  _ _  _      _                _
 | || |__ _ _ __  / __| \| | \| |___ | |_ ___ _ _ __| |_
 | __ / _` | '  \| (_ | .` | .` |___||  _/ _ \ '_/ _| ' \
 |_||_\__,_|_|_|_|\___|_|\_|_|\_|     \__\___/_| \__|_||_|
"""


def git_revision() -> str:
    """Short git hash of the checkout holding this package, or '' outside
    a git checkout."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    try:
        out = subprocess.run(["git", "-C", root, "rev-parse", "--short", "HEAD"],
                             capture_output=True, text=True, timeout=5)
    except (OSError, subprocess.SubprocessError):
        return ""
    return out.stdout.strip() if out.returncode == 0 else ""


def version_string() -> str:
    rev = git_revision()
    return f"hamgnn_tpu_torch {__version__}" + (f" (git {rev})" if rev else "")


def print_banner() -> None:
    print(_BANNER)
    print(version_string())
