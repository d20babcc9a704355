"""utils (port of ``sentinel_tpu/utils``)."""
