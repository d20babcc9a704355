"""Test support for the port: the deterministic device-fault injector
(:mod:`sentinel_tpu_torch.testing.faults`)."""
