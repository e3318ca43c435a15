"""Device stages of the port: tensors in, tensors out (see aligner.py)."""
