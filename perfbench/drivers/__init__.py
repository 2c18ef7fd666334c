"""A driver per kind of traffic: it builds the cell's inputs from the
seed, warms up, runs the measured window through the port's entry,
checks what the window produced against the plain reference and hands
back a ``harness.Outcome``."""
