"""Streaming partitioners: shared state, the engine, FENNEL, LDG, CUTTANA."""
