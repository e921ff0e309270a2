"""Decoding for the rationale family: greedy and sampled KV-cached decode and
the ``generate`` front end (port of part of the JAX package's
``generation/``)."""
