"""Frozen input generators: the corpus and query geometry of the port's
``synth.py``, copied so that the program cannot move the yardstick."""
