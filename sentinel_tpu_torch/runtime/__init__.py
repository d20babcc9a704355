"""runtime (port of ``sentinel_tpu/runtime``)."""
