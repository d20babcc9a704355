"""metrics (port of ``sentinel_tpu/metrics``)."""
