"""Part of the plain reference: see vctbench/reference/pipeline.py."""
