"""The plain reference and its control: see pipeline.py."""
