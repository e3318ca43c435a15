"""Synthetic worlds of the port: repeat-structured genomes (genome.py)."""
