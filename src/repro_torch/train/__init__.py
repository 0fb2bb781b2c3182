"""Step factories (port of ``repro.train``): so far the serving steps only;
the training step, optimizer, schedule and checkpoints wait for the training
slice (ROADMAP Queue 1 item 8b)."""
