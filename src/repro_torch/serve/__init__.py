"""Serving (port of ``repro.serve``): so far LM serving, :mod:`.lm`."""
