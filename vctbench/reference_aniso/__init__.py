"""The plain reference of anisotropic configurations: see pipeline.py."""
