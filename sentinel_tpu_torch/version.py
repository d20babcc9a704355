"""Framework version (a copy of ``sentinel_tpu/version.py``: the port
reports the version of the package it ports).

Mirrors the reference's version constant (Constants.java:34,
SENTINEL_VERSION = "1.8.4"); this framework tracks its own versioning.
"""

__version__ = "0.4.0"
