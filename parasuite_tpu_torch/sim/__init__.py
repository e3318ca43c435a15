"""Synthetic worlds of the port: repeat-structured genomes (genome.py),
the PAR-CLIP read simulator (generate.py) and the jax.random Threefry
stream it draws from (threefry.py)."""
