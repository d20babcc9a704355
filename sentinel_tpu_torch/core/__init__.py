"""core (port of ``sentinel_tpu/core``)."""
