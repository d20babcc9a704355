"""Rule datasources of the port. Only the shared retry backoff is here so
far (:mod:`~sentinel_tpu_torch.datasource.backoff`, which the engine
supervisor and the cluster client use); the sources themselves are ROADMAP
Queue 1 item 11."""
