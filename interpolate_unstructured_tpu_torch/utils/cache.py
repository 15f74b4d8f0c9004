"""Where the port's compiled libraries are kept.

The JAX package's ``enable_compile_cache`` turns on jax's persistent
compile cache.  The port compiles two libraries of its own: the CUDA
kernels (``ops/_kernels.py``, into ``<dir>/kernels/``) and the serial
C++ oracle (``utils/serial_oracle.py``, into ``<dir>/serial_oracle/``).
Each is named by a hash of its sources and flags, so a changed source
rebuilds once and an unchanged one loads at once from the directory set
here.  The default is ``build/`` at the repository root.
"""

from __future__ import annotations

from pathlib import Path

DEFAULT_DIR = Path(__file__).resolve().parents[2] / "build"
_dir = DEFAULT_DIR


def enable_compile_cache(path=None) -> None:
    """Build and load the port's libraries under ``path`` (``None``: the
    default ``build/`` at the repository root).

    Safe to call more than once and before any build; a library already
    loaded in this process stays loaded, the next build goes to the new
    directory.  The directory is made when a library is first built
    there.
    """
    global _dir
    _dir = DEFAULT_DIR if path is None else Path(path).expanduser().resolve()


def build_dir(name: str) -> Path:
    """The directory that the library ``name`` builds into."""
    return _dir / name
