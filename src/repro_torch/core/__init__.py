"""Streaming partitioners: shared state, the engine, and the zoo the
registry (:mod:`repro_torch.api.registry`) names."""
