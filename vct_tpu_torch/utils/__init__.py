"""Host utilities: image IO (image.py) and stage timing (profiling.py)."""
