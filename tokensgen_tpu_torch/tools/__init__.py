"""CLIs of the probe kernels (`kernels/probes.py`), one per Pallas probe script of
the JAX package's ``tools/``: each runs at its script's own shapes on the card
(``--device cpu`` runs the plain versions on the host at any size) and prints
one line per case: time, rate and error against the plain version."""
