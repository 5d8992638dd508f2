"""Errors of the port (counterpart of ``spmv_scpa_tpu/errors.py``): the
ones the loader, validation and the CLI raise, each with an errno-style
``code`` as the reference study's ``ERR_PTR`` convention has
(include/err.h:10-18); the CLI exits with it.
"""

from __future__ import annotations

import errno


class SpmvError(Exception):
    """Base error; carries an errno-style code."""

    code: int = 1

    def __init__(self, message: str, code: int | None = None):
        super().__init__(message)
        if code is not None:
            self.code = code


class MatrixFormatError(SpmvError):
    """Unsupported or malformed Matrix Market content (csr.c:48-52)."""

    code = errno.EINVAL


class MatrixBoundsError(SpmvError):
    """Entry coordinates outside the declared matrix shape (csr.c:84-87)."""

    code = errno.ERANGE


class ValidationError(SpmvError):
    """A result diverged from the fp64 oracle beyond tolerance
    (utils.c:39-60)."""

    code = errno.EIO


class ConfigError(SpmvError):
    """Bad CLI or configuration input (the usage abort, main.c:58-64)."""

    code = errno.EINVAL
