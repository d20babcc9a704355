"""Test support for the port: the deterministic device-fault injector
(:mod:`sentinel_tpu_torch.testing.faults`) and the sequential oracle
(:mod:`sentinel_tpu_torch.testing.oracle`), the reference's semantics one
request at a time, which a stream through the engine is held against."""
