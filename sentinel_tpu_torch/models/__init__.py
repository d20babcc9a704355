"""models (port of ``sentinel_tpu/models``)."""
