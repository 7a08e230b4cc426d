"""Codec profiles — the framework's "model zoo".

An LZS framework has no neural models; the analogue of a model family is
a *codec profile*: a named (offset coder, length coder, framing) bundle.
``standard`` is the ANSI X3.241-1994 wire format implemented by the device
kernels and the reference C library; the others exercise the generalized
coder layer (python/lzs.py:171-641 capability).
"""

from .profiles import PROFILES, get_profile  # noqa: F401
